"""ConvNet3D's later-stage convolution op (``ops/conv3d_s2.py``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here the
op's plain version stands in for it. These tests hold the plain version to
``F.conv3d``, the three autograd Functions to numerical gradients to second
order, the route inside ConvNet3D to the ``F.conv3d`` path through one
S2D-MTT outer step in fp64, the gate, and the vmap rules.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from torch_threads import one_torch_thread  # noqa: F401
from video_distillation_torch.distill import mtt as tmtt
from video_distillation_torch.distill.s2d import (S2DConfig,
                                                  init_s2d_momentum,
                                                  init_s2d_state)
from video_distillation_torch.models.convnet3d import ConvNet3D
from video_distillation_torch.ops import conv3d_s2 as c3

SMALL = (2, 16, 4, 8, 8)  # (B, Cin, F, H, W); Cout 16


def _inputs(shape, cout, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=gen, dtype=dtype)
    w = torch.randn(cout, shape[1], 3, 7, 7, generator=gen, dtype=dtype) * 0.1
    b = torch.randn(cout, generator=gen, dtype=dtype)
    return x, w, b


def _conv(x, w, b=None):
    return F.conv3d(x, w, b, stride=(1, 2, 2), padding=(1, 3, 3))


@pytest.mark.parametrize("shape,cout", [(SMALL, 16), ((1, 4, 3, 9, 11), 8),
                                        ((2, 8, 1, 7, 7), 32)])
def test_plain_op_and_its_gradients_match_conv3d(shape, cout):
    x, w, b = _inputs(shape, cout)
    y = c3.conv3d_s2(x, w, b)
    assert y.shape == (shape[0], cout, shape[2], c3.out_size(shape[3]),
                       c3.out_size(shape[4]))
    assert torch.equal(y, _conv(x, w, b))
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    ref = torch.autograd.grad(_conv(xr, wr, br), (xr, wr, br), g)
    assert torch.allclose(c3.Conv3dS2Dgrad.apply(g, w, x), ref[0], rtol=1e-12,
                          atol=1e-12)
    assert torch.allclose(c3.Conv3dS2Wgrad.apply(x, g, w), ref[1], rtol=1e-12,
                          atol=1e-12)
    got = torch.autograd.grad(c3.conv3d_s2(xr, wr, br), (xr, wr, br), g)
    for a, r in zip(got, ref):
        assert torch.allclose(a, r, rtol=1e-12, atol=1e-12)


def test_gradcheck_and_gradgradcheck_through_the_three_functions():
    x, w, b = _inputs(SMALL, 16)
    x, w, b = (t.requires_grad_(True) for t in (x, w, b))
    assert torch.autograd.gradcheck(c3.Conv3dS2.apply, (x, w, b),
                                    fast_mode=True)
    assert torch.autograd.gradgradcheck(c3.Conv3dS2.apply, (x, w, b),
                                        fast_mode=True)
    g = torch.randn(2, 16, 4, 4, 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    x_like, w_like = x.detach(), w.detach()
    assert torch.autograd.gradgradcheck(
        lambda g_, w_: c3.Conv3dS2Dgrad.apply(g_, w_, x_like), (g, w),
        fast_mode=True)
    assert torch.autograd.gradgradcheck(
        lambda x_, g_: c3.Conv3dS2Wgrad.apply(x_, g_, w_like), (x, g),
        fast_mode=True)


def _count_fprop(monkeypatch, route):
    """Route every ConvNet3D stage the gate lets through when ``route``, on
    the CPU (the plain version standing in for the kernel), counting
    ``fprop`` calls: each is a kernel launch on the card."""
    calls = {"conv3d_s2_fprop": 0}
    plain = c3.fprop

    def counted(*args):
        calls["conv3d_s2_fprop"] += 1
        return plain(*args)

    monkeypatch.setattr(c3, "fprop", counted)
    monkeypatch.setattr(c3, "routes",
                        lambda x, w: route and x.shape[1] % 16 == 0)
    return calls


def _s2d_step(steps, dtype="float64"):
    nc = 3
    cfg = S2DConfig(num_classes=nc, frames=8, im_size=(64, 64))
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg)
    state = {k: (v.double() if torch.is_tensor(v) else
                 [{n: t.double() for n, t in h.items()} for h in v])
             for k, v in state.items()}
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, nc, (64, 64), 8, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, nc, (64, 64), 8, gen)
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, nc, (64, 64), 8, steps, cfg,
        tmtt.S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True), dtype, "cpu")
    masks = torch.rand(steps, nc, 1, 1, 1, 128,
                       generator=torch.Generator().manual_seed(3)) < 0.5
    return step(torch.Generator().manual_seed(1), state,
                torch.tensor(0.01, dtype=torch.float64),
                init_s2d_momentum(state), torch.zeros((), dtype=torch.float64),
                t0.double(), t1.double(), torch.tensor([[0, 1, 2]] * steps),
                keep_masks=masks)


def test_s2d_mtt_meta_gradient_through_the_route_equals_conv3d(monkeypatch):
    """One fp64 S2D-MTT outer step (64x64x8, 3 classes, syn_steps 2) with
    stages 2 and 3 routed against the same step through ``F.conv3d``: the
    loss and every outer gradient within 1e-10 (the same convolutions, the
    double backward's sums in another order). Each inner step calls the
    forward three times a routed stage: in the unroll, and twice in the
    outer backward (the double backward of dgrad and of wgrad)."""
    steps = 2
    calls = _count_fprop(monkeypatch, route=False)
    ref = _s2d_step(steps)
    assert calls["conv3d_s2_fprop"] == 0
    calls = _count_fprop(monkeypatch, route=True)
    got = _s2d_step(steps)
    assert calls["conv3d_s2_fprop"] == 3 * steps * 2
    assert abs(float(got[4]) / float(ref[4]) - 1) <= 1e-10
    flat = lambda g: [g["dynamic"], g["syn_lr"], *g["hals"][0].values()]
    for a, r in zip(flat(got[7]), flat(ref[7])):
        assert float((a - r).norm()) <= 1e-10 * float(r.norm())


def test_the_gate_reads_dtype_device_and_channels():
    def fake(cuda, dtype, cin, cout=128, w=28, b=50):
        x = SimpleNamespace(is_cuda=cuda, dtype=dtype,
                            shape=(b, cin, 16, w, w), dim=lambda: 5)
        wt = SimpleNamespace(dtype=dtype, shape=(cout, cin, 3, 7, 7))
        return x, wt

    assert c3.routes(*fake(True, torch.bfloat16, 64))
    assert c3.routes(*fake(True, torch.bfloat16, 64, b=6))  # M 18,816
    # the distillation cells' third stages (M 6,400 and 4,096) keep cuDNN
    assert not c3.routes(*fake(True, torch.bfloat16, 128, w=7, b=25))
    assert not c3.routes(*fake(True, torch.bfloat16, 64, b=5))  # M 15,680
    assert not c3.routes(*fake(True, torch.float32, 64))  # fp32 keeps cuDNN
    assert not c3.routes(*fake(False, torch.bfloat16, 64))  # CPU
    assert not c3.routes(*fake(True, torch.bfloat16, 3))  # a plain first stage
    assert not c3.routes(*fake(True, torch.bfloat16, 64, cout=24))
    assert not c3.routes(*fake(True, torch.bfloat16, 64, w=1024, b=1))
    x, w, _ = _inputs(SMALL, 16, dtype=torch.float32)
    assert not c3.routes(x, w) and not c3.routes(x.bfloat16(), w.bfloat16())

    c3.reset_launches()
    net = ConvNet3D(3, 4, frames=8, im_size=(64, 64),
                    generator=torch.Generator().manual_seed(0))
    net(torch.randn(2, 8, 64, 64, 3))
    net.fuse_first_stage = False
    net(torch.randn(2, 8, 64, 64, 3))
    assert c3.LAUNCHES == {"conv3d_s2_fprop": 0}


def test_a_routed_forward_launches_once_a_stage(monkeypatch):
    calls = _count_fprop(monkeypatch, route=True)
    net = ConvNet3D(3, 4, frames=8, im_size=(64, 64),
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 64, 64, 3)
    with torch.no_grad():
        got = net(x)
    assert calls["conv3d_s2_fprop"] == 2
    monkeypatch.setattr(c3, "routes", lambda x, w: False)
    with torch.no_grad():
        assert torch.equal(got, net(x))


def test_the_wrapper_checks_what_it_takes():
    x, w, b = _inputs(SMALL, 16)
    with pytest.raises(ValueError, match="weight takes 8 input channels"):
        c3.fprop(x, w[:, :8], b)
    with pytest.raises(ValueError, match=r"\(Cout, Cin, 3, 7, 7\)"):
        c3.fprop(x, w[..., :5], b)
    with pytest.raises(ValueError, match="bias must be"):
        c3.fprop(x, w, b[:3])
    with pytest.raises(ValueError, match="one CUDA device or all be on"):
        c3.fprop(x, w.to("meta"), b)


def test_vmap_folds_the_nets_and_raises_on_a_mapped_weight():
    x, w, b = _inputs((2, 8, 2, 8, 8), 8)
    xs = torch.stack([x, 2 * x - 1, x.flip(-1)])
    got = torch.func.vmap(c3.conv3d_s2, in_dims=(0, None, None))(xs, w, b)
    for v in range(3):
        assert torch.allclose(got[v], _conv(xs[v], w, b), rtol=1e-12,
                              atol=1e-12)

    ws = torch.stack([w, -w])
    with pytest.raises(NotImplementedError, match="vmap over the weight"):
        torch.func.vmap(c3.conv3d_s2, in_dims=(None, 0, None))(x, ws, b)

    # batched gradients: dgrad with gO mapped, wgrad net by net
    loss = lambda x_, w_: (torch.sin(c3.conv3d_s2(x_, w_, b)) ** 2).sum()
    ref_loss = lambda x_, w_: (torch.sin(_conv(x_, w_, b)) ** 2).sum()
    for argnums in (0, 1):
        got = torch.func.vmap(torch.func.grad(loss, argnums=argnums),
                              in_dims=(0, None))(xs, w)
        for v in range(3):
            ref = torch.func.grad(ref_loss, argnums=argnums)(xs[v], w)
            assert torch.allclose(got[v], ref, rtol=1e-10, atol=1e-12)
