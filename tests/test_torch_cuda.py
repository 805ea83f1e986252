"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
elsewhere. The file imports no JAX, so it runs on a machine without it;
``tests/conftest.py`` does import JAX, so on the card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 results within 1e-5 of the largest |value| (the same sums
in other orders); a bf16 result within one bf16 rounding (2^-7 relative)
of the plain version computed in fp32 from the same bf16 inputs, plus 1e-5
of the largest |value| for the fp32 summation order. The first-stage
kernels copy values: pack, the phase trio and the winner index equal their
plain versions bit for bit; unpack sums three values in fp32 in the plain
version's order and rounds once, so it equals the plain version bit for
bit in both dtypes. The later-stage convolution (``ops.conv3d_s2``, bf16
only) sums in fp32 and rounds once, so it is held to the bf16 bound against
``F.conv3d`` in fp32 (TF32 off) from the same bf16 inputs.
"""

import pytest
import torch

from video_distillation_torch.ops import conv3d_s2 as c3
from video_distillation_torch.ops import hal_conv as hc
from video_distillation_torch.ops import hal_fused as hf
from video_distillation_torch.ops import phase_trio as pt
from video_distillation_torch.ops import s2d2_move as sm

pytestmark = pytest.mark.cuda

# odd sizes: a ragged last block, W not a multiple of the warp, F = 1 and 2,
# H not a multiple of hal_wgrad's 8-row band at the slice's width; for
# hal_dgrad's tiling, H one past its 16-row band, W one past a 16-pixel unit
# and one past its 112-column band, F = 1 and 2 at width 112
SHAPES = [(3, 5, 12, 20), (2, 1, 7, 9), (1, 2, 33, 17), (4, 8, 32, 32),
          (2, 3, 13, 112), (2, 1, 17, 112), (1, 2, 16, 113), (2, 2, 17, 17)]

# hal_fused's edge cases: widths 13 and 113 (not multiples of 4: the
# kernel's element paths), F = 1 and 2, H = 1, and batches whose runs end
# inside a block (B*H*ceil(W/4) not a multiple of 256)
FUSED_SHAPES = [(2, 1, 9, 13), (1, 2, 16, 113), (2, 2, 1, 13), (3, 4, 1, 112),
                (3, 2, 7, 112), (5, 3, 9, 20)]


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
    _assert_deterministic(dk, db, g, s, d)


def _assert_deterministic(dk, db, g, s, d):
    """A second hal_wgrad call on the same inputs gives the same bits (a
    fixed summation order, no atomics)."""
    dk2, db2 = hc.hal_wgrad(g, s, d)
    assert torch.equal(dk, dk2) and torch.equal(db, db2)


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
    _assert_deterministic(dk, db, g, s, d)


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


@pytest.mark.parametrize("shape", SHAPES + FUSED_SHAPES)
def test_fused_kernel_matches_plain(cuda, shape):
    """hal_fused (fp32, no grad) against its plain version and hal_fwd's;
    one launch counted in its own counter, none in hal_conv's."""
    s, d, w, b, _ = _inputs(shape, torch.float32, seed=3)
    hc.reset_launches()
    hf.reset_launches()
    y = hf.hal_fused(s, d, w, b)
    assert hf.LAUNCHES == {"hal_fused": 1}
    assert set(hc.LAUNCHES.values()) == {0}
    assert y.dtype == torch.float32 and tuple(y.shape) == (*shape, 3)
    _close_fp32(y, hf.hal_fused_plain(s, d, w, b))
    _close_fp32(y, hc.hal_fwd(s, d, w, b).permute(0, 2, 3, 4, 1))
    assert y.permute(0, 4, 1, 2, 3).is_contiguous()


def test_fused_kernel_is_deterministic(cuda):
    s, d, w, b, _ = _inputs((3, 16, 112, 112), torch.float32, seed=5)
    assert torch.equal(hf.hal_fused(s, d, w, b), hf.hal_fused(s, d, w, b))


def test_fused_back_to_back_launches_with_other_weights(cuda):
    """The kernel takes its weights from a constant bank filled on the
    launch's stream: two launches queued back to back with different
    weights (the evaluation's n_hal > 1 path) each use their own."""
    s, d, w1, b1, _ = _inputs((2, 5, 24, 40), torch.float32, seed=6)
    _, _, w2, b2, _ = _inputs((2, 5, 24, 40), torch.float32, seed=7)
    y1 = hf.hal_fused(s, d, w1, b1)
    y2 = hf.hal_fused(s, d, w2, b2)
    y3 = hf.hal_fused(s, d, w1, b1)
    _close_fp32(y1, hf.hal_fused_plain(s, d, w1, b1))
    _close_fp32(y2, hf.hal_fused_plain(s, d, w2, b2))
    assert torch.equal(y1, y3)


def test_fused_wrapper_raises_on_what_it_does_not_take(cuda):
    s, d, w, b, _ = _inputs((1, 2, 8, 8), torch.float32)
    with pytest.raises(TypeError, match="fp32"):
        hf.hal_fused(s.bfloat16(), d.bfloat16(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        hf.hal_fused(s.transpose(1, 2).contiguous().transpose(1, 2), d, w, b)
    with pytest.raises(ValueError, match="one CUDA device or all be on"):
        hf.hal_fused(s, d.cpu(), w, b)


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


# (B, F, H, W, C): F = 1 and 2, H != W, C = 3 and a generic C, a ragged block,
# an odd packed width (W/2 + 4 = 11), and rows (and, in bf16, a tensor) whose
# byte length is not a multiple of 16; F = 9 spans two of unpack's 8-frame
# blocks
MOVER_SHAPES = [(2, 4, 8, 8, 3), (1, 1, 12, 8, 3), (3, 2, 16, 20, 2),
                (2, 5, 36, 28, 3), (1, 3, 10, 14, 3), (1, 3, 2, 6, 1),
                (2, 9, 4, 112, 3)]
# (N, O, rows_per_batch): ragged row tiles, batches that split a tile, O not
# a multiple of 32
TRIO_SHAPES = [(100, 64, 100), (100, 64, 25), (77, 8, 7), (64, 40, 64)]


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MOVER_SHAPES)
def test_s2d2_movers_match_plain(cuda, shape, dtype):
    b, f, h, w, c = shape
    x = _randn(shape, dtype, 4)
    sm.reset_launches()
    assert torch.equal(sm.pack(x), sm.pack_plain(x))
    g = _randn((b, f, h // 2 + 4, w // 2 + 4, 12 * c), dtype, 5)
    out = sm.unpack_sum(g, h, w)
    assert out.dtype == dtype
    assert torch.equal(out, sm.unpack_plain(g, h, w))
    assert sm.LAUNCHES == {"s2d2_pack": 1, "s2d2_unpack": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_takes_an_unaligned_input(cuda, dtype):
    """A contiguous input that starts one element past a 16-byte boundary
    is staged word by word, bit-equal all the same."""
    flat = _randn((1 + 2 * 36,), dtype, 7)
    x = flat[1:].view(2, 3, 2, 6, 1)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(sm.pack(x), sm.pack_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_takes_an_unaligned_input(cuda, dtype):
    """A packed input one element past a 16-byte boundary is staged word by
    word, bit-equal all the same."""
    n = 2 * 3 * 8 * 9 * 36
    g = _randn((1 + n,), dtype, 8)[1:].view(2, 3, 8, 9, 36)
    assert g.data_ptr() % 16 != 0
    assert torch.equal(sm.unpack_sum(g, 8, 10), sm.unpack_plain(g, 8, 10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dgrad_takes_an_unaligned_input(cuda, dtype):
    """ȳ one element past a 16-byte boundary: hal_dgrad stages it element
    by element, within the usual tolerance of the plain version."""
    b, f, h, w = 2, 3, 17, 112
    g = _randn((1 + b * 3 * f * h * w,), dtype, 9)[1:].view(b, 3, f, h, w)
    assert g.data_ptr() % 16 != 0
    wt = _randn((3, 4, 3, 3, 3), dtype, 10)
    rs, rd = hc.hal_dgrad_plain(g.float(), wt.float())
    ds, dd = hc.hal_dgrad(g, wt)
    close = _close_fp32 if dtype == torch.float32 else _close_bf16
    close(ds, rs)
    close(dd, rd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_takes_an_unaligned_input(cuda, dtype):
    """Static and dynamic one element past a 16-byte boundary: hal_fwd
    stages them element by element, within the usual tolerance of the plain
    version."""
    b, f, h, w = 2, 3, 17, 112
    st = _randn((1 + b * h * w * 3,), dtype, 11)[1:].view(b, h, w, 3)
    dy = _randn((1 + b * f * h * w,), dtype, 12)[1:].view(b, f, h, w, 1)
    assert st.data_ptr() % 16 != 0 and dy.data_ptr() % 16 != 0
    wt, bs = _randn((3, 4, 3, 3, 3), dtype, 13), _randn((3,), dtype, 14)
    ref = hc.hal_fwd_plain(st.float(), dy.float(), wt.float(), bs.float())
    close = _close_fp32 if dtype == torch.float32 else _close_bf16
    close(hc.hal_fwd(st, dy, wt, bs), ref)


def _trio_inputs(n, o, g, dtype, seed, ties=False):
    y = _randn((n, 4 * o), dtype, seed)
    if ties:  # round so that phases tie often
        y = (y * 2).round().to(dtype)
    t = _randn((n, 4 * o), dtype, seed + 1)
    c = pt.to_planar(_randn((n, o), dtype, seed + 2), g)
    return y, t, c


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRIO_SHAPES)
def test_phase_trio_matches_plain(cuda, shape, dtype, ties):
    n, o, g = shape
    y, t, c = _trio_inputs(n, o, g, dtype, 6, ties)
    pt.reset_launches()
    m, idx = pt.phase_argmax(y, g)
    rm, ridx = pt.phase_argmax_plain(y, g)
    assert torch.equal(m, rm) and torch.equal(idx, ridx)
    assert torch.equal(pt.phase_select(t, idx, g), pt.phase_select_plain(t, idx, g))
    assert torch.equal(pt.phase_scatter(c, idx, g),
                       pt.phase_scatter_plain(c, idx, g))
    assert pt.LAUNCHES == {"phase_argmax": 1, "phase_select": 1,
                           "phase_scatter": 1}


def test_fused_stage_twice_differentiable_on_the_card(cuda):
    """One second-order pass through the fused stage, kernels against the
    plain versions on the CPU (fp32): each kernel launches as on the CPU
    its plain version is called."""
    from video_distillation_torch.models.layers import s2d2_conv_pool
    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(2, 4, 16, 16, 3, generator=gen)
    w0 = torch.randn(8, 3, 3, 7, 7, generator=gen) * 0.1
    b0 = torch.randn(8, generator=gen)

    def hvp(dev):
        x = x0.to(dev).requires_grad_(True)
        w = w0.to(dev).requires_grad_(True)
        loss = torch.sin(s2d2_conv_pool(x, w, b0.to(dev))).sum()
        (gw,) = torch.autograd.grad(loss, w, create_graph=True)
        return torch.autograd.grad((gw ** 2).sum(), (x, w))

    sm.reset_launches()
    pt.reset_launches()
    got = hvp("cuda")
    assert sm.LAUNCHES == {"s2d2_pack": 1, "s2d2_unpack": 1}
    assert pt.LAUNCHES == {"phase_argmax": 1, "phase_select": 1,
                           "phase_scatter": 2}
    for a, r in zip(got, hvp("cpu")):
        assert float((a.cpu() - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_first_stage_wrappers_raise_instead_of_falling_back(cuda):
    x = _randn((1, 2, 8, 8, 3), torch.float32, 0)
    with pytest.raises(TypeError, match="not supported"):
        sm.pack(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        sm.pack(x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        sm.unpack_sum(sm.pack(x).transpose(2, 3).contiguous().transpose(2, 3),
                      8, 8)
    y = _randn((8, 32), torch.float32, 1)
    m, idx = pt.phase_argmax(y, 4)
    with pytest.raises(TypeError, match="not supported"):
        pt.phase_argmax(y.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        pt.phase_select(y.t().contiguous().t(), idx, 4)
    with pytest.raises(ValueError, match="contiguous"):
        pt.phase_scatter(m, idx.t().contiguous().t(), 4)
    with pytest.raises(ValueError, match="one CUDA device or all be on"):
        pt.phase_scatter(m, idx.cpu(), 4)
    with pytest.raises(ValueError, match="uint8"):
        pt.phase_scatter(m, idx.int(), 4)


# ConvNet3D's later stages as the distillation cells run them ((B, Cin, F,
# H, W), Cout): ucf's and k400's second and third stages; then W odd (the
# input staged element by element), a plane of more than 256 outputs (row
# bands), Cout past one block of 128 channels, F = 1
CONV3D_S2_SHAPES = [((50, 64, 16, 28, 28), 128), ((256, 64, 8, 16, 16), 128),
                    ((50, 128, 8, 7, 7), 128), ((256, 128, 4, 4, 4), 128),
                    ((2, 16, 3, 9, 11), 16), ((1, 16, 2, 40, 36), 32),
                    ((2, 32, 1, 12, 12), 144)]


def _conv_inputs(shape, cout, seed):
    x = _randn(shape, torch.bfloat16, seed)
    wt = (_randn((cout, shape[1], 3, 7, 7), torch.float32, seed + 1)
          * (shape[1] * 147) ** -0.5).to(torch.bfloat16)
    return x, wt, _randn((cout,), torch.bfloat16, seed + 2)


@pytest.mark.parametrize("shape,cout", CONV3D_S2_SHAPES)
def test_conv3d_s2_rounds_once_and_is_deterministic(cuda, shape, cout):
    x, wt, bs = _conv_inputs(shape, cout, 0)
    c3.reset_launches()
    y = c3.fprop(x, wt, bs)
    _close_bf16(y, c3.fprop_plain(x.float(), wt.float(), bs.float()))
    assert torch.equal(y, c3.fprop(x, wt, bs))
    _close_bf16(c3.fprop(x, wt), c3.fprop_plain(x.float(), wt.float()))
    assert c3.LAUNCHES == {"conv3d_s2_fprop": 3}


def test_conv3d_s2_takes_an_unaligned_input(cuda):
    x, wt, bs = _conv_inputs((2, 16, 3, 12, 16), 16, 3)
    xu = torch.empty(x.numel() + 1, device="cuda", dtype=x.dtype)[1:]
    xu = xu.view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    assert torch.equal(c3.fprop(xu, wt, bs), c3.fprop(x, wt, bs))


def test_conv3d_s2_wrapper_raises_instead_of_falling_back(cuda):
    x, wt, bs = _conv_inputs((1, 16, 2, 8, 8), 16, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        c3.fprop(x.float(), wt.float(), bs.float())
    with pytest.raises(ValueError, match="contiguous"):
        c3.fprop(x.transpose(3, 4).contiguous().transpose(3, 4), wt, bs)
    with pytest.raises(ValueError, match="one CUDA device or all be on"):
        c3.fprop(x, wt.cpu(), bs)


def _rel(a, r):
    return float((a.float() - r.float()).norm() / r.float().norm())


def test_convnet3d_route_gradients_on_the_card(cuda, monkeypatch):
    """First- and second-order gradients of a bf16 ConvNet3D (32 clips of
    64x64x8, the K400 configuration's stages, fp32 head) through the route and through
    ``F.conv3d`` (the gate forced shut), each against the fp32 net: the
    route within twice cuDNN's distance of fp32, or 1e-2 (relative norm;
    two bf16 paths whose sums round in other places)."""
    from video_distillation_torch.models.convnet3d import ConvNet3D
    gen = torch.Generator().manual_seed(0)
    net = ConvNet3D(3, 4, frames=8, im_size=(64, 64), generator=gen).cuda()
    # 32 clips: the second stage's M is 16,384, routed
    x0 = torch.randn(32, 8, 64, 64, 3, generator=gen).cuda()
    y = torch.arange(32, device="cuda") % 4
    params = list(net.parameters())

    def grads(dtype):
        x = x0.to(dtype).requires_grad_(True)
        logits = net(x, fp32_stages=("head",) if dtype != torch.float32 else ())
        loss = torch.nn.functional.cross_entropy(logits.float(), y)
        g = torch.autograd.grad(loss, params, create_graph=True)
        gg = torch.autograd.grad(sum((t.float() ** 2).sum() for t in g),
                                 [x] + params)
        return [t.detach().float() for t in g + gg]

    ref = grads(torch.float32)
    c3.reset_launches()
    routed = grads(torch.bfloat16)
    launches = c3.LAUNCHES["conv3d_s2_fprop"]
    c3.reset_launches()
    with torch.no_grad():
        net(x0.bfloat16())
    stages = c3.LAUNCHES["conv3d_s2_fprop"]
    assert stages >= 1 and launches == 3 * stages
    monkeypatch.setattr(c3, "routes", lambda x, w: False)
    cudnn = grads(torch.bfloat16)
    for i, (a, c, r) in enumerate(zip(routed, cudnn, ref)):
        assert _rel(a, r) <= max(2 * _rel(c, r), 1e-2), (i, _rel(a, r),
                                                          _rel(c, r))


def test_conv3d_s2_launches_per_outer_step(cuda):
    """One bf16 S2D-MTT outer step (112x112x16, 8 classes, syn_steps 2):
    the kernel launches 3 x syn_steps times per routed stage (each inner
    forward, and the two forward convolutions of each inner step's double
    backward); the stages routed are those one forward of the inner batch
    launches (the second: M = 8*16*14*14 = 25,088)."""
    from video_distillation_torch.distill import mtt as tmtt
    from video_distillation_torch.distill.s2d import (
        S2DConfig, init_s2d_momentum, init_s2d_state)
    nc, steps, im, f = 8, 2, 112, 16
    cfg = S2DConfig(num_classes=nc, frames=f, im_size=(im, im))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_s2d_state(gen, cfg, "cuda")
    model, t0 = tmtt.flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                         gen, "cuda")
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, nc, (im, im), f, gen,
                                     "cuda")
    c3.reset_launches()
    with torch.no_grad():
        model(torch.randn(nc, f, im, im, 3, device="cuda").bfloat16())
    stages = c3.LAUNCHES["conv3d_s2_fprop"]
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, nc, (im, im), f, steps, cfg,
        tmtt.S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True), "bfloat16",
        "cuda")
    c3.reset_launches()
    out = step(torch.Generator(device="cuda").manual_seed(1), state,
               torch.tensor(0.01, device="cuda"), init_s2d_momentum(state),
               torch.zeros((), device="cuda"), t0, t1,
               torch.tensor([list(range(nc))] * steps, device="cuda"))
    assert torch.isfinite(out[4])
    assert stages >= 1
    assert c3.LAUNCHES == {"conv3d_s2_fprop": 3 * steps * stages}
