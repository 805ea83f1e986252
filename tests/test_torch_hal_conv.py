"""The port's hallucinator composition (``ops/hal_conv.py``) against the JAX
package: the Pallas primitive ``hal_vjp.hal_conv`` in interpret mode and
the flax ``Hallucinator``, on the same numpy inputs and weights.

On the CPU the port's wrappers run their plain version (broadcast + concat
+ ``F.conv3d``); the CUDA kernels are checked against that plain version
on the card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
Tolerance rtol = atol = 5e-4, as ``tests/test_hal_vjp.py`` uses: fp32
stencils summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.models.hallucinator import \
    Hallucinator as JaxHallucinator
from video_distillation_tpu.ops.pallas import hal_vjp
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.ops import hal_conv as hc
from torch_threads import one_torch_thread  # noqa: F401

B, F, H, W = 2, 4, 16, 16
TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(hal_vjp, "INTERPRET", True)


def _inputs(seed, mode="concat", shape=(B, F, H, W)):
    b, f, h, w = shape
    rng = np.random.default_rng(seed)
    static = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    dynamic = rng.normal(size=(b, f, h, w, 1)).astype(np.float32)
    cot = rng.normal(size=(b, f, h, w, 3)).astype(np.float32)
    hal = JaxHallucinator(mode=mode)
    params = hal.init(jax.random.PRNGKey(seed), jnp.asarray(static),
                      jnp.asarray(dynamic))["params"]
    port = from_jax_params(Hallucinator(mode), params)
    return hal, params, port, static, dynamic, cot


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# the forward kernel's edge cases on the card: one frame at an odd width,
# rows that are not a multiple of 16 bytes (staged element by element, a
# ragged last chunk), H not a multiple of its 16-row band
@pytest.mark.parametrize("shape", [(B, F, H, W), (2, 1, 7, 9), (1, 2, 16, 113),
                                   (2, 3, 13, 112)])
def test_forward_matches_pallas_and_flax(shape):
    hal, params, port, static, dynamic, _ = _inputs(0, shape=shape)
    out = hc.hal_conv(_t(static), _t(dynamic), port["weight"], port["bias"])
    assert out.shape == (*shape, 3)
    ref_flax = hal.apply({"params": params}, static, dynamic)
    ref_pallas = hal_vjp.hal_conv(jnp.asarray(static), jnp.asarray(dynamic),
                                  params["kernel"], params["bias"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_flax), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_pallas), **TOL)


@pytest.mark.parametrize("train_static", [True, False])
def test_grads_match_pallas(train_static):
    """Grads of <y, ȳ> for (static, dynamic, kernel, bias); with a frozen
    static the port's backward gets no static grad (need_s False)."""
    _, params, port, static, dynamic, cot = _inputs(1)

    def jax_loss(s, d, k, b):
        if not train_static:
            s = jax.lax.stop_gradient(s)
        return jnp.sum(hal_vjp.hal_conv(s, d, k, b) * cot)

    gs, gd, gk, gb = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(static), jnp.asarray(dynamic), params["kernel"],
        params["bias"])
    s, d = _t(static, train_static), _t(dynamic, True)
    w = port["weight"].clone().requires_grad_(True)
    b = port["bias"].clone().requires_grad_(True)
    (hc.hal_conv(s, d, w, b) * _t(cot)).sum().backward()
    if train_static:
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), **TOL)
    else:
        assert s.grad is None
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), **TOL)
    np.testing.assert_allclose(w.grad.numpy(),
                               np.asarray(gk).transpose(4, 3, 0, 1, 2), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("need_s,need_d", [(True, True), (True, False),
                                           (False, True)])
def test_dgrad_flags(need_s, need_d):
    """hal_dgrad returns only the requested cotangents, each equal to the
    Pallas transpose's."""
    _, params, port, _, _, cot = _inputs(2)
    g = _t(cot).permute(0, 4, 1, 2, 3).contiguous()
    ds, dd = hc.hal_dgrad(g, port["weight"], need_s, need_d)
    rs, rd = hal_vjp._dgrad_impl(jnp.asarray(cot), params["kernel"], B, F, H,
                                 W, jnp.float32)
    if need_s:
        np.testing.assert_allclose(ds.numpy(), np.asarray(rs), **TOL)
    else:
        assert ds is None
    if need_d:
        np.testing.assert_allclose(dd.numpy(), np.asarray(rd), **TOL)
    else:
        assert dd is None


# the kernel's edge cases: one and two frames, odd H and W, H not a
# multiple of the kernel's 8-row band
@pytest.mark.parametrize("shape", [(B, F, H, W), (2, 1, 7, 9), (1, 2, 7, 9),
                                   (1, 3, 13, 8)])
def test_wgrad_matches_pallas(shape):
    _, _, _, static, dynamic, cot = _inputs(3, shape=shape)
    g = _t(cot).permute(0, 4, 1, 2, 3).contiguous()
    dk, db = hc.hal_wgrad(g, _t(static), _t(dynamic))
    rk, rb = hal_vjp._wgrad_impl(jnp.asarray(cot), jnp.asarray(static),
                                 jnp.asarray(dynamic))
    np.testing.assert_allclose(dk.numpy(),
                               np.asarray(rk).transpose(4, 3, 0, 1, 2), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(rb), **TOL)


def test_add_mode_matches_flax():
    hal, params, port, static, dynamic, cot = _inputs(4, mode="add")
    s, d = _t(static, True), _t(dynamic, True)
    out = Hallucinator("add")
    out.load_state_dict(port)
    y = out(s, d)
    ref = hal.apply({"params": params}, static, dynamic)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
    (y * _t(cot)).sum().backward()
    gs, gd = jax.grad(lambda a, b: jnp.sum(
        hal.apply({"params": params}, a, b) * cot), argnums=(0, 1))(
            jnp.asarray(static), jnp.asarray(dynamic))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), **TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gd), **TOL)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper given a CUDA tensor launches its kernel or raises; the
    plain version is only for CPU tensors."""
    calls = []
    monkeypatch.setattr(hc, "hal_fwd_plain",
                        lambda *a: calls.append(a) or a[1])
    s, d = torch.zeros(1, 4, 4, 3), torch.zeros(1, 2, 4, 4, 1)
    w, b = torch.zeros(3, 4, 3, 3, 3), torch.zeros(3)
    hc.hal_fwd(s, d, w, b)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="one CUDA device or all be on the CPU"):
        hc.hal_fwd(s.to("meta"), d, w, b)
    assert len(calls) == 1


def test_wrappers_reject_bad_shapes():
    s, d = torch.zeros(1, 4, 4, 3), torch.zeros(1, 2, 4, 4, 1)
    w, b = torch.zeros(3, 4, 3, 3, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="static must be"):
        hc.hal_fwd(s[:, :3], d, w, b)
    with pytest.raises(ValueError, match="weight must be"):
        hc.hal_fwd(s, d, w[:, :3], b)
    with pytest.raises(ValueError, match="planar"):
        hc.hal_dgrad(torch.zeros(1, 2, 4, 4, 3), w)
