"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
elsewhere. The file imports no JAX, so it runs on a machine without it;
``tests/conftest.py`` does import JAX, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 results within 1e-5 of the largest |value| (the same sums
in other orders); a bf16 result within one bf16 rounding (2^-7 relative)
of the plain version computed in fp32 from the same bf16 inputs, plus 1e-5
of the largest |value| for the fp32 summation order.
"""

import pytest
import torch

from video_distillation_torch.ops import hal_conv as hc

pytestmark = pytest.mark.cuda

# odd sizes: a ragged last block, W not a multiple of the warp, F = 1 and 2
SHAPES = [(3, 5, 12, 20), (2, 1, 7, 9), (1, 2, 33, 17), (4, 8, 32, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, seed=0):
    b, f, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return (mk(b, h, w, 3), mk(b, f, h, w, 1), mk(3, 4, 3, 3, 3), mk(3),
            mk(b, 3, f, h, w))


def _close_fp32(out, ref):
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-5 * float(ref.float().abs().max()), err


def _close_bf16(out, ref):
    o, r = out.float(), ref.float()
    bound = 2.0 ** -7 * r.abs() + 1e-5 * float(r.abs().max())
    assert bool(((o - r).abs() <= bound).all()), float((o - r).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_kernels_match_plain(cuda, shape):
    s, d, w, b, g = _inputs(shape, torch.float32)
    _close_fp32(hc.hal_fwd(s, d, w, b), hc.hal_fwd_plain(s, d, w, b))
    rs, rd = hc.hal_dgrad_plain(g, w)
    for need_s, need_d in ((True, True), (True, False), (False, True)):
        ds, dd = hc.hal_dgrad(g, w, need_s, need_d)
        assert (ds is None) != need_s and (dd is None) != need_d
        if need_s:
            _close_fp32(ds, rs)
        if need_d:
            _close_fp32(dd, rd)
    dk, db = hc.hal_wgrad(g, s, d)
    rk, rb = hc.hal_wgrad_plain(g, s, d)
    _close_fp32(dk, rk)
    _close_fp32(db, rb)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_kernels_round_once(cuda, shape):
    s, d, w, b, g = _inputs(shape, torch.bfloat16, seed=1)
    f32 = lambda *ts: [t.float() for t in ts]
    _close_bf16(hc.hal_fwd(s, d, w, b), hc.hal_fwd_plain(*f32(s, d, w, b)))
    ds, dd = hc.hal_dgrad(g, w)
    rs, rd = hc.hal_dgrad_plain(*f32(g, w))
    _close_bf16(ds, rs)
    _close_bf16(dd, rd)
    # wgrad sums in fp32 from the bf16 inputs; the plain version does too
    dk, db = hc.hal_wgrad(g, s, d)
    rk, rb = hc.hal_wgrad_plain(g, s, d)
    assert dk.dtype == torch.float32
    err = max(float((dk - rk).abs().max()), float((db - rb).abs().max()))
    assert err <= 1e-5 * float(torch.cat([rk.flatten(), rb]).abs().max())


@pytest.mark.parametrize("train_static", [True, False])
def test_autograd_through_the_kernels(cuda, train_static):
    """hal_conv's backward (hal_dgrad + hal_wgrad) against autograd of the
    plain forward; one launch of each kernel per forward and backward."""
    s, d, w, b, g = _inputs((2, 4, 16, 16), torch.float32, seed=2)
    cot = g.permute(0, 2, 3, 4, 1)

    def grads(fn):
        leaves = [s.clone().requires_grad_(train_static),
                  d.clone().requires_grad_(True),
                  w.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        (fn(*leaves) * cot).sum().backward()
        return [t.grad for t in leaves]

    hc.reset_launches()
    got = grads(hc.hal_conv)
    assert hc.LAUNCHES == {"hal_fwd": 1, "hal_dgrad": 1, "hal_wgrad": 1}
    ref = grads(lambda *a: hc.hal_fwd_plain(*a).permute(0, 2, 3, 4, 1))
    assert hc.LAUNCHES == {"hal_fwd": 1, "hal_dgrad": 1, "hal_wgrad": 1}
    for a, r in zip(got, ref):
        if r is None:
            assert a is None
        else:
            _close_fp32(a, r)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    s, d, w, b, g = _inputs((1, 2, 8, 8), torch.float32)
    with pytest.raises(TypeError, match="mixed dtypes"):
        hc.hal_fwd(s, d.to(torch.bfloat16), w, b)
    with pytest.raises(TypeError, match="not supported"):
        hc.hal_fwd(s.half(), d.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        hc.hal_dgrad(g.transpose(3, 4).contiguous().transpose(3, 4), w)
    with pytest.raises(ValueError, match="one CUDA device or all be on"):
        hc.hal_fwd(s, d.cpu(), w, b)
