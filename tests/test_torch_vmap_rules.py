"""The ``torch.func.vmap`` rules of the port's kernel Functions, on the CPU.

Each rule folds the mapped axis into the sample axis and makes one call of
the unbatched Function (the JAX batching rules, ``hal_vjp.py:396-426``,
``phase_trio.py:205-225``, ``s2d2_move.py:200-212``). On the CPU a wrapper
computes its kernel's plain version, so a vmapped call over E nets must
equal a loop of E unbatched calls, and the plain version must run once per
vmapped call (the card launches the kernel where the CPU calls it). The
per-sample maps are held bit-equal; the weight gradient, which sums over
the folded samples, within 1e-6 relative of the loop's sum. Also the
refusals: a mapped hallucinator weight or bias, a select or scatter whose
operands are not both mapped, and a row group that would straddle nets.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from video_distillation_torch.ops import hal_conv as hc
from video_distillation_torch.ops import phase_trio as pt
from video_distillation_torch.ops import s2d2_move as sm

E, B, F, H, W = 3, 2, 4, 6, 8
O, G = 5, 6  # phase trio: O channels, G rows a batch


def _r(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.fixture
def calls(monkeypatch):
    """Counts of each plain version's calls (one a kernel launch on the
    card)."""
    counts = {}
    for mod, name in ((hc, "hal_fwd_plain"), (hc, "hal_dgrad_plain"),
                      (hc, "hal_wgrad_plain"), (pt, "phase_argmax_plain"),
                      (pt, "phase_select_plain"), (pt, "phase_scatter_plain"),
                      (sm, "pack_plain"), (sm, "unpack_plain")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return counts


def _hal_inputs():
    return (_r(E, B, H, W, 3, seed=1), _r(E, B, F, H, W, 1, seed=2),
            _r(3, 4, 3, 3, 3, seed=3) * 0.2, _r(3, seed=4))


@pytest.mark.parametrize("static_mapped", [True, False],
                         ids=["mapped", "broadcast"])
def test_hal_conv_rule_equals_a_loop(calls, static_mapped):
    s, d, wt, b = _hal_inputs()
    s_in = s if static_mapped else s[0]
    got = vmap(hc.hal_conv, in_dims=(0 if static_mapped else None, 0, None,
                                     None))(s_in, d, wt, b)
    assert calls == {"hal_fwd_plain": 1}
    for e in range(E):
        ref = hc.hal_conv(s[e] if static_mapped else s[0], d[e], wt, b)
        assert torch.equal(got[e], ref)


def test_hal_conv_refuses_a_mapped_weight_or_bias():
    s, d, wt, b = _hal_inputs()
    with pytest.raises(NotImplementedError, match="plain module"):
        vmap(hc.hal_conv, in_dims=(0, 0, 0, None))(s, d, wt.expand(E, *wt.shape), b)
    with pytest.raises(NotImplementedError, match="plain module"):
        vmap(hc.hal_conv, in_dims=(0, 0, None, 0))(s, d, wt, b.expand(E, 3))


def test_hal_conv_backward_through_the_rule(calls):
    """grad outside vmap: one dgrad and one wgrad call over the folded
    samples; the shared weight's gradient is the sum over the nets."""
    s, d, wt, b = _hal_inputs()
    ybar = _r(E, B, F, H, W, 3, seed=5)

    def loss(s, d, wt, b):
        return (vmap(hc.hal_conv, in_dims=(0, 0, None, None))(s, d, wt, b)
                * ybar).sum()

    got = torch.func.grad(loss, argnums=(0, 1, 2, 3))(s, d, wt, b)
    assert calls["hal_dgrad_plain"] == 1 and calls["hal_wgrad_plain"] == 1
    ref = [torch.func.grad(lambda *a: (hc.hal_conv(*a) * ybar[e]).sum(),
                           argnums=(0, 1, 2, 3))(s[e], d[e], wt, b)
           for e in range(E)]
    for i in (0, 1):
        assert torch.equal(got[i], torch.stack([r[i] for r in ref]))
    for i in (2, 3):
        want = sum(r[i].double() for r in ref)
        err = (got[i].double() - want).norm() / want.norm()
        assert err <= 1e-6, err


def test_hal_conv_per_net_gradients_under_vmap_of_grad(calls):
    """vmap outside grad: the backward runs batched; each net's weight
    gradient comes apart from one wgrad call."""
    s, d, wt, b = _hal_inputs()
    ybar = _r(E, B, F, H, W, 3, seed=5)

    def loss(wt, b, s, d, yb):
        return (hc.hal_conv(s, d, wt, b) * yb).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2, 3)),
               in_dims=(None, None, 0, 0, 0))(wt, b, s, d, ybar)
    assert calls["hal_dgrad_plain"] == 1 and calls["hal_wgrad_plain"] == E
    for e in range(E):
        ref = grad(loss, argnums=(0, 1, 2, 3))(wt, b, s[e], d[e], ybar[e])
        for i in range(4):
            assert torch.allclose(got[i][e], ref[i], rtol=1e-6, atol=1e-6), i


def test_hal_wgrad_nets_sums_each_net_apart():
    g, s, d = _r(E * B, 3, F, H, W, seed=6), _r(E * B, H, W, 3), _r(E * B, F, H, W, 1)
    dk, db = hc.hal_wgrad(g, s, d, nets=E)
    assert dk.shape == (E, 3, 4, 3, 3, 3) and db.shape == (E, 3)
    for e in range(E):
        rk, rb = hc.hal_wgrad(*(t[e * B:(e + 1) * B] for t in (g, s, d)))
        assert torch.equal(dk[e], rk) and torch.equal(db[e], rb)
    with pytest.raises(ValueError, match="divide"):
        hc.hal_wgrad(g, s, d, nets=4)


def test_phase_argmax_rule_equals_a_loop(calls):
    y = _r(E, 4 * G, 4 * O, seed=7)
    m, idx = vmap(pt.PhaseArgmax.apply, in_dims=(0, None))(y, G)
    assert calls == {"phase_argmax_plain": 1}
    assert m.shape == (E, 4, O, G) and idx.shape == (E, 4 * G, O)
    for e in range(E):
        rm, ri = pt.PhaseArgmax.apply(y[e], G)
        assert torch.equal(m[e], rm) and torch.equal(idx[e], ri)


def test_phase_argmax_rule_refuses_groups_across_nets():
    with pytest.raises(ValueError, match="straddles"):
        vmap(pt.PhaseArgmax.apply, in_dims=(0, None))(_r(E, 9, 4 * O), 6)


@pytest.mark.parametrize("name", ["PhaseSelect", "PhaseScatter"])
def test_select_and_scatter_rules_equal_a_loop(calls, name):
    y = _r(E, 4 * G, 4 * O, seed=8)
    _, idx = pt.PhaseArgmax.apply(y.flatten(0, 1), G)
    idx = idx.unflatten(0, (E, -1))
    fn = getattr(pt, name).apply
    a = _r(E, 4 * G, 4 * O, seed=9) if name == "PhaseSelect" else _r(E, 4, O, G, seed=9)
    got = vmap(fn, in_dims=(0, 0, None))(a, idx, G)
    key = "phase_select_plain" if name == "PhaseSelect" else "phase_scatter_plain"
    assert calls[key] == 1
    for e in range(E):
        assert torch.equal(got[e], fn(a[e], idx[e], G))
    with pytest.raises(NotImplementedError, match="both operands"):
        vmap(fn, in_dims=(0, None, None))(a, idx[0], G)
    with pytest.raises(NotImplementedError, match="both operands"):
        vmap(fn, in_dims=(None, 0, None))(a[0], idx, G)


def test_phase_max_backward_under_vmap_of_grad(calls):
    """vmap(grad): PhaseArgmax's backward (PhaseScatter) runs batched, one
    call for the nets."""
    y = _r(E, 4 * G, 4 * O, seed=10)
    cot = _r(E, 4, O, G, seed=11)

    def loss(y, c):
        return (pt.phase_max(y, G) * c).sum()

    got = vmap(grad(loss))(y, cot)
    assert calls == {"phase_argmax_plain": 1, "phase_scatter_plain": 1}
    for e in range(E):
        assert torch.equal(got[e], grad(loss)(y[e], cot[e]))


@pytest.mark.parametrize("name", ["Pack", "Unpack"])
def test_pack_and_unpack_rules_equal_a_loop(calls, name):
    x = _r(E, B, F, 8, 12, 3, seed=12)
    if name == "Pack":
        a, fn, dims = x, sm.Pack.apply, 0
    else:
        a = sm.pack_plain(x.flatten(0, 1)).unflatten(0, (E, B)) * 1.5
        fn, dims = (lambda g: sm.Unpack.apply(g, 8, 12)), 0
    calls.clear()
    got = vmap(fn, in_dims=dims)(a)
    assert calls == {f"{name.lower()}_plain": 1}
    for e in range(E):
        assert torch.equal(got[e], fn(a[e]))


def test_pack_backward_under_vmap_of_grad(calls):
    x = _r(E, B, F, 8, 12, 3, seed=13)
    cot = _r(E, B, F, 8, 10, 36, seed=14)

    def loss(x, c):
        return (sm.s2d2_pack(x) * c).sum()

    got = vmap(grad(loss))(x, cot)
    assert calls == {"pack_plain": 1, "unpack_plain": 1}
    for e in range(E):
        assert torch.equal(got[e], grad(loss)(x[e], cot[e]))


def test_s2d2_weight_is_channels_last():
    """The packed first-stage kernel comes channels-last from its permute
    (``contiguous(memory_format=...)`` has no vmap rule)."""
    from video_distillation_torch.models.layers import s2d2_weight
    ws = s2d2_weight(_r(64, 3, 3, 7, 7))
    assert ws.shape == (256, 36, 5, 5)
    assert ws.is_contiguous(memory_format=torch.channels_last)
