"""The port's phase-max trio (``ops/phase_trio.py``, plain versions on the
CPU) against the JAX package's: its Pallas kernels in interpret mode and
the XLA where-chain ``layers._phase_max_xla``.

Inputs from numpy seeds. Tolerances: max, index, select, scatter and the
first-order gradient are copies of input values, so exact; the
second-order HVP (torch double backward against JAX's grad-of-jvp) at the
JAX package's own rtol 1e-5 (``tests/test_phase_trio.py``) through a
sine loss (the JAX tests' tanh loss cancels in 1 - tanh^2, which the two
frameworks round differently by up to 4e-6); the adjoint identity at 1e-6 relative
(fp32 dot products summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.models.layers import _phase_max_xla
from video_distillation_tpu.ops.pallas import phase_trio as jpt
from video_distillation_torch.ops import phase_trio as pt
from torch_threads import one_torch_thread  # noqa: F401

N, O = 48, 8
# m's channel-planar layout: 4 batches of 12 rows, and one batch of all rows
ROWS_PER_BATCH = [12, N]


@pytest.fixture(autouse=True)
def _interpret():
    jpt.INTERPRET = True
    yield
    jpt.INTERPRET = False


def _np(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rows(m):
    """A planar torch result as (N, O) numpy rows."""
    return pt.from_planar(m).numpy()


@pytest.mark.parametrize("g", ROWS_PER_BATCH)
def test_argmax_matches_jax_kernel_and_xla(g):
    y = _np(0, (N, 4 * O))
    m, idx = pt.phase_argmax(torch.from_numpy(y), g)
    assert idx.dtype == torch.uint8 and tuple(m.shape) == (N // g, O, g)
    jm, jidx = jpt.phase_argmax(jnp.asarray(y))
    np.testing.assert_array_equal(_rows(m), np.asarray(jm))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx).astype(np.uint8))
    np.testing.assert_array_equal(_rows(m), np.asarray(_phase_max_xla(y)))
    np.testing.assert_array_equal(_rows(pt.phase_max(torch.from_numpy(y), g)),
                                  np.asarray(jm))


# (phase values, the winner): every kind of tie goes to the first maximum
TIES = [((1, 1, 1, 1), 0), ((2, 2, 0, 1), 0), ((0, 3, 3, 1), 1),
        ((0, 1, 4, 4), 2), ((5, 0, 1, 5), 0), ((0, 5, 1, 5), 1),
        ((0, 1, 5, 5), 2), ((-1, -1, -1, -2), 0), ((0, 0, 0, 0), 0)]


def test_ties_go_to_the_first_maximum():
    y = np.zeros((len(TIES), 4 * O), np.float32)
    for r, (vals, _) in enumerate(TIES):
        for k, v in enumerate(vals):
            y[r, k * O:(k + 1) * O] = v
    want = np.array([w for _, w in TIES], np.uint8)[:, None].repeat(O, 1)
    _, idx = pt.phase_argmax(torch.from_numpy(y), len(TIES))
    _, jidx = jpt.phase_argmax(jnp.asarray(y))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jidx).astype(np.uint8), want)
    # the gradient follows the index: one unit to the winner's slot
    yt = torch.from_numpy(y).requires_grad_(True)
    pt.phase_max(yt, 1).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(_phase_max_xla(v)))(jnp.asarray(y))
    np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(jg))
    assert (yt.grad.numpy().reshape(len(TIES), 4, O).argmax(1) == want).all()


@pytest.mark.parametrize("g", ROWS_PER_BATCH)
def test_select_and_scatter_match_jax(g):
    y, t, c = _np(1, (N, 4 * O)), _np(2, (N, 4 * O)), _np(3, (N, O))
    _, idx = pt.phase_argmax(torch.from_numpy(y), g)
    _, jidx = jpt.phase_argmax(jnp.asarray(y))
    sel = pt.phase_select(torch.from_numpy(t), idx, g)
    np.testing.assert_array_equal(
        _rows(sel), np.asarray(jpt.phase_select(jnp.asarray(t), jidx)))
    ct = pt.to_planar(torch.from_numpy(c), g)
    np.testing.assert_array_equal(
        pt.phase_scatter(ct, idx, g).numpy(),
        np.asarray(jpt.phase_scatter(jnp.asarray(c), jidx)))


@pytest.mark.parametrize("g", ROWS_PER_BATCH)
def test_first_order_grad_matches_jax(g):
    y, w = _np(4, (N, 4 * O)), _np(5, (N, O))
    yt = torch.from_numpy(y).requires_grad_(True)
    (pt.phase_max(yt, g) * pt.to_planar(torch.from_numpy(w), g)).sum().backward()
    for fn in (jpt.phase_max, _phase_max_xla):
        ref = jax.grad(lambda v: jnp.sum(fn(v) * w))(jnp.asarray(y))
        np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(ref))


def test_second_order_hvp_matches_jax():
    y0, v, w = _np(6, (N, 4 * O)), _np(7, (N, 4 * O)), _np(8, (N, O))

    def jax_hvp(fn):
        loss = lambda y: jnp.sum(jnp.sin(fn(y) * w))  # noqa: E731
        return jax.grad(lambda y: jax.jvp(loss, (y,), (jnp.asarray(v),))[1])(
            jnp.asarray(y0))

    y = torch.from_numpy(y0).requires_grad_(True)
    loss = torch.sin(pt.from_planar(pt.phase_max(y, 12)) * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(loss, y, create_graph=True)
    assert type(g.grad_fn).__name__ == "PhaseScatterBackward"
    (hv,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), y)
    for fn in (jpt.phase_max, _phase_max_xla):
        np.testing.assert_allclose(hv.numpy(), np.asarray(jax_hvp(fn)),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("g", ROWS_PER_BATCH)
def test_select_and_scatter_are_adjoint(g):
    y, t, c = _np(9, (N, 4 * O)), _np(10, (N, 4 * O)), _np(11, (N, O))
    _, idx = pt.phase_argmax(torch.from_numpy(y), g)
    ct = pt.to_planar(torch.from_numpy(c), g)
    lhs = float((pt.phase_select(torch.from_numpy(t), idx, g) * ct).sum())
    rhs = float((torch.from_numpy(t) * pt.phase_scatter(ct, idx, g)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-6)


@pytest.mark.parametrize("g", [4, 8])
def test_gradgradcheck_fp64(g):
    rng = np.random.default_rng(12)
    y = torch.tensor(rng.normal(size=(8, 4 * 3)), requires_grad=True)
    t = torch.tensor(rng.normal(size=(8, 4 * 3)), requires_grad=True)
    _, idx = pt.phase_argmax(y.detach(), g)
    c = pt.to_planar(torch.tensor(rng.normal(size=(8, 3))), g).requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda a: pt.phase_max(a, g) ** 3, (y,))
    assert torch.autograd.gradgradcheck(
        lambda a: pt.PhaseSelect.apply(a, idx, g) ** 2, (t,))
    assert torch.autograd.gradgradcheck(
        lambda a: pt.PhaseScatter.apply(a, idx, g) ** 2, (c,))


def test_wrappers_check_shapes():
    y = torch.zeros(6, 4 * O)
    with pytest.raises(ValueError, match="4\\*O"):
        pt.phase_argmax(torch.zeros(6, 7), 6)
    for g in (4, 0):
        with pytest.raises(ValueError, match="divide"):
            pt.phase_argmax(y, g)
    _, idx = pt.phase_argmax(y, 3)
    with pytest.raises(ValueError, match="uint8"):
        pt.phase_select(y, idx.long(), 3)
    with pytest.raises(ValueError, match="expected"):
        pt.phase_scatter(torch.zeros(6, O), idx, 3)
