"""The port's s2d2 mover pair (``ops/s2d2_move.py``, plain versions on the
CPU) against the JAX package's: its Pallas kernels in interpret mode and
the XLA chain ``layers.s2d2_pack``.

Inputs from numpy seeds. Tolerances: pack is a copy, so exact; unpack and
the first-order gradient (a 3-term sum in fp32) within 1e-6 relative of
the JAX values, or exact where the JAX side sums in the same order; in
bf16, unpack equals the exact sum rounded once, and the JAX results (which
round after each add) lie within 2^-7 of the terms' magnitudes of it; the
second-order HVP (torch double backward against JAX's grad-of-jvp) at the
JAX package's own rtol 1e-4 (``tests/test_s2d2_move.py``) through a
sine loss (the JAX tests' tanh loss cancels in 1 - tanh^2, which the two
frameworks round differently by up to 4e-6); the adjoint
identity at 1e-5 relative (fp32 dot products of ~10^4 terms in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.models.layers import s2d2_pack as jax_xla_pack
from video_distillation_tpu.ops.pallas import s2d2_move as jsm
from video_distillation_torch.ops import s2d2_move as sm
from torch_threads import one_torch_thread  # noqa: F401

# (B, F, H, W, C): the JAX tests' shape, one frame, H != W with C != 3, an
# odd packed width (W/2 + 4 = 11), and one frame with an odd packed width
SHAPES = [(2, 4, 8, 8, 3), (1, 1, 8, 12, 3), (2, 3, 12, 8, 2),
          (1, 3, 10, 14, 3), (2, 1, 6, 10, 3)]


@pytest.fixture(autouse=True)
def _interpret():
    jsm.INTERPRET = True
    yield
    jsm.INTERPRET = False


def _np(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _packed_shape(shape):
    b, f, h, w, c = shape
    return (b, f, h // 2 + 4, w // 2 + 4, 12 * c)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_matches_jax_kernel_and_xla(shape):
    x = _np(0, shape)
    out = sm.pack(torch.from_numpy(x)).numpy()
    assert out.shape == _packed_shape(shape)
    np.testing.assert_array_equal(out, np.asarray(jsm.pack(jnp.asarray(x))))
    np.testing.assert_array_equal(out, np.asarray(jax_xla_pack(jnp.asarray(x))))


@pytest.mark.parametrize("shape", SHAPES)
def test_unpack_matches_jax_kernel(shape):
    h, w = shape[2:4]
    g = _np(1, _packed_shape(shape))
    out = sm.unpack_sum(torch.from_numpy(g), h, w).numpy()
    ref = np.asarray(jsm.unpack_sum(jnp.asarray(g), h, w))
    assert out.shape == shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_unpack_bf16_rounds_the_exact_sum_once(shape):
    """In bf16 the port's unpack is the exact (fp64) sum of each element's
    three slots rounded once to bf16. The JAX package's Pallas kernel and
    the vjp of its XLA chain add in bf16, rounding after each add, so they
    may differ from it by more than one rounding (a known difference, not a
    fault): both stay within 2^-7 of the sum of the terms' magnitudes."""
    b, f, h, w, c = shape
    g16 = torch.from_numpy(_np(1, _packed_shape(shape))).bfloat16()
    out = sm.unpack_sum(g16, h, w)
    assert out.dtype == torch.bfloat16
    exact = sm.unpack_plain(g16.double(), h, w)  # fp64, exact for 3 bf16 terms
    magnitude = sm.unpack_plain(g16.double().abs(), h, w).numpy()
    assert torch.equal(out, exact.to(torch.bfloat16))
    gj = jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(jax_xla_pack, jnp.zeros((b, f, h, w, c), jnp.bfloat16))
    for ref in (jsm.unpack_sum(gj, h, w), vjp(gj)[0]):
        assert ref.dtype == jnp.bfloat16
        err = np.abs(np.asarray(ref.astype(jnp.float32), np.float64) - exact.numpy())
        assert np.all(err <= 2.0 ** -7 * magnitude)


@pytest.mark.parametrize("shape", SHAPES)
def test_first_order_grad_matches_jax(shape):
    x, w = _np(2, shape), _np(3, _packed_shape(shape))
    xt = torch.from_numpy(x).requires_grad_(True)
    (sm.s2d2_pack(xt) * torch.from_numpy(w) ** 2).sum().backward()
    grads = {name: np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * w ** 2))(
        jnp.asarray(x))) for name, fn in (("pallas", jsm.pack),
                                          ("xla", jax_xla_pack))}
    # the Pallas transpose sums the three slots in the port's order
    np.testing.assert_array_equal(xt.grad.numpy(), grads["pallas"])
    np.testing.assert_allclose(xt.grad.numpy(), grads["xla"], rtol=1e-6,
                               atol=1e-6 * np.abs(grads["xla"]).max())


def test_second_order_hvp_matches_jax():
    shape = SHAPES[0]
    x0, v, w = _np(4, shape), _np(5, shape), _np(6, _packed_shape(shape))

    def jax_hvp(fn):
        loss = lambda x: jnp.sum(jnp.sin(fn(x) * w))  # noqa: E731
        return jax.grad(lambda x: jax.jvp(loss, (x,), (jnp.asarray(v),))[1])(
            jnp.asarray(x0))

    x = torch.from_numpy(x0).requires_grad_(True)
    loss = torch.sin(sm.s2d2_pack(x) * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    assert type(g.grad_fn).__name__ == "UnpackBackward"
    (hv,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), x)
    for fn in (jsm.pack, jax_xla_pack):
        np.testing.assert_allclose(hv.numpy(), np.asarray(jax_hvp(fn)),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_and_unpack_are_adjoint(shape):
    h, w = shape[2:4]
    x, g = torch.from_numpy(_np(7, shape)), torch.from_numpy(_np(8, _packed_shape(shape)))
    lhs = float((sm.pack(x) * g).sum())
    rhs = float((x * sm.unpack_sum(g, h, w)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-5)


def test_gradgradcheck_fp64():
    rng = np.random.default_rng(9)
    shape = (1, 3, 4, 4, 2)
    x = torch.tensor(rng.normal(size=shape), requires_grad=True)
    g = torch.tensor(rng.normal(size=_packed_shape(shape)), requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda a: sm.s2d2_pack(a) ** 2, (x,))
    assert torch.autograd.gradgradcheck(lambda a: sm.Unpack.apply(a, 4, 4) ** 2,
                                        (g,))


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="even"):
        sm.pack(torch.zeros(1, 2, 7, 8, 3))
    with pytest.raises(ValueError, match="12C"):
        sm.unpack_sum(torch.zeros(1, 2, 8, 8, 36), 10, 8)
