"""The fused no-grad hallucinator composition (``ops/hal_fused.py``) and the
evaluation-time slot draw, against the JAX package on the CPU.

* ``hal_fused_plain`` against ``hallucinate_fused(..., interpret=True)``
  (the Pallas kernel run by its interpreter), on the same numpy inputs and
  the same weights carried over with ``JaxLayout.for_hallucinator``:
  within 2e-4, the tolerance of ``tests/test_pallas_hallucinator.py``
  (fp32 stencils summed in other orders). It must also agree with the
  port's ``hal_fwd_plain`` (the same conv, 1e-6).
* On the CPU the wrapper computes the plain version: fp32 only, no graph.
* ``eval_slot_draw`` applies ``_eval_slot_draw``'s rules exactly, given
  the JAX function's own draws.
"""

import jax
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import evaluate as jeval
from video_distillation_tpu.ops.pallas.hallucinator_kernel import \
    hallucinate_fused
from video_distillation_torch.distill import s2d as ts2d
from video_distillation_torch.distill.params import JaxLayout
from video_distillation_torch.ops import hal_conv as hc
from video_distillation_torch.ops import hal_fused as hf


def _inputs(b, f, h, w, seed=0):
    rng = np.random.default_rng(seed)
    static = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    dynamic = rng.normal(size=(b, f, h, w, 1)).astype(np.float32)
    kernel = (0.2 * rng.normal(size=(3, 3, 3, 4, 3))).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    return static, dynamic, kernel, bias


@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 1, 7, 9), (2, 2, 1, 13),
                                   (1, 3, 5, 113)])
def test_plain_matches_the_pallas_kernel(shape):
    static, dynamic, kernel, bias = _inputs(*shape)
    ref = np.asarray(hallucinate_fused(static, dynamic, kernel, bias,
                                       interpret=True))
    p = JaxLayout.for_hallucinator().from_jax({"kernel": kernel, "bias": bias})
    st, dy = torch.from_numpy(static), torch.from_numpy(dynamic)
    got = hf.hal_fused(st, dy, p["weight"], p["bias"])
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    same = hc.hal_fwd_plain(st, dy, p["weight"], p["bias"]).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), same.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_fp32_and_records_no_graph():
    static, dynamic, kernel, bias = _inputs(1, 2, 8, 8)
    p = JaxLayout.for_hallucinator().from_jax({"kernel": kernel, "bias": bias})
    w = p["weight"].requires_grad_(True)
    st, dy = torch.from_numpy(static), torch.from_numpy(dynamic)
    y = hf.hal_fused(st, dy, w, p["bias"])
    assert not y.requires_grad and y.grad_fn is None
    with pytest.raises(TypeError, match="fp32"):
        hf.hal_fused(st.double(), dy.double(), w, p["bias"])
    with pytest.raises(ValueError, match=r"\(B, F, H, W, 1\)"):
        hf.hal_fused(st, dy[..., 0], w, p["bias"])
    hf.reset_launches()
    hf.hal_fused(st, dy, w, p["bias"])
    assert hf.LAUNCHES == {"hal_fused": 0}  # the plain version launches nothing


def test_hallucinate_frozen_refuses_a_differentiable_input():
    cfg = ts2d.S2DConfig(num_classes=2, frames=4, im_size=(8, 8))
    st = ts2d.init_s2d_state(torch.Generator().manual_seed(0), cfg)
    static, dynamic = st["static"][:2], st["dynamic"][:, 0]
    y = ts2d.hallucinate_frozen(st["hals"][0], static, dynamic)
    ref = ts2d.hallucinate(st["hals"][0], static, dynamic)
    torch.testing.assert_close(y, ref.detach(), rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="hallucinate\\(\\)"):
        ts2d.hallucinate_frozen(st["hals"][0], static,
                                dynamic.clone().requires_grad_(True))
    with torch.no_grad():  # no graph can be recorded: allowed
        ts2d.hallucinate_frozen(st["hals"][0], static,
                                dynamic.clone().requires_grad_(True))


@pytest.mark.parametrize("spc,dpc,n_hal,n", [(2, 2, 1, 7), (10, 10, 3, 12),
                                             (2, 4, 2, 5)])
def test_eval_slot_draw_matches_jax(spc, dpc, n_hal, n):
    key = jax.random.PRNGKey(11)
    num_classes = 3
    vpc = 5 if spc == 10 else 1
    idx = np.random.default_rng(0).integers(0, num_classes * vpc, n)
    ref = jeval._eval_slot_draw(key, jax.numpy.asarray(idx), spc, dpc, n_hal)
    k1, k2, k3 = jax.random.split(key, 3)
    hi_s, hi_d = (2, 2) if spc == 10 else (spc, dpc)
    draws = [np.array(jax.random.randint(k, (n,), 0, hi))
             for k, hi in ((k1, hi_s), (k2, hi_d), (k3, n_hal))]
    got = ts2d.eval_slot_draw(torch.from_numpy(idx), spc, dpc, n_hal,
                              draws=draws)
    for a, r in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="spc in"):
        ts2d.eval_slot_draw(torch.from_numpy(idx), 4, dpc, n_hal)
