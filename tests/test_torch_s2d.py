"""The port's S2D parameterization against the JAX package's.

JAX's PRNG streams cannot be matched by torch, so each test reproduces the
JAX function's own ``jax.random`` draws from its key and hands them to the
port (``draws``): the slot rules must then agree exactly, and the composed
videos within 5e-4 (fp32 stencils summed in other orders, as
``tests/test_hal_vjp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import s2d as js2d
from video_distillation_torch.distill import s2d as ts2d
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.models.hallucinator import Hallucinator
from torch_threads import one_torch_thread  # noqa: F401


def jax_distill_draws(key, n):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.randint(k1, (n,), 0, 2)),
            np.array(jax.random.randint(k2, (n,), 0, 2)))


def jax_eval_draws(key, cfg):
    n = cfg.num_classes * (5 if cfg.spc == 10 else 1)
    k1, k2, k3 = jax.random.split(key, 3)
    hi_s, hi_d = (2, 2) if cfg.spc == 10 else (cfg.spc, cfg.dpc)
    return (np.array(jax.random.randint(k1, (n,), 0, hi_s)),
            np.array(jax.random.randint(k2, (n,), 0, hi_d)),
            np.array(jax.random.randint(k3, (n,), 0, cfg.n_hal)))


@pytest.mark.parametrize("C,spc,vpc", [(5, 10, 5), (4, 2, 1)])
def test_distill_slots_match_jax(C, spc, vpc):
    key = jax.random.PRNGKey(7)
    n = C * vpc
    ref = js2d.distill_slots(key, C, spc, vpc, n, jnp.arange(n))
    got = ts2d.distill_slots(C, spc, vpc, torch.arange(n),
                             draws=jax_distill_draws(key, n))
    for a, r in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("spc,dpc,n_hal", [(10, 10, 3), (2, 2, 2)])
def test_eval_slots_match_jax(spc, dpc, n_hal):
    key = jax.random.PRNGKey(3)
    cfg = ts2d.S2DConfig(num_classes=4, spc=spc, dpc=dpc, n_hal=n_hal)
    ref = js2d.eval_slots(key, 4, spc, dpc, n_hal)
    got = ts2d.eval_slots(4, spc, dpc, n_hal,
                          draws=jax_eval_draws(key, cfg))
    for a, r in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(r))


def test_eval_slots_rejects_other_spc():
    with pytest.raises(ValueError, match="spc in"):
        ts2d.eval_slots(3, 4, 2, 1)


def test_slot_ranges_with_a_generator():
    gen = torch.Generator().manual_seed(0)
    C, spc, vpc = 5, 10, 5
    idx = torch.arange(C * vpc)
    label, s, d = ts2d.distill_slots(C, spc, vpc, idx, generator=gen)
    assert torch.equal(label, idx // vpc)
    assert bool(((s >= label * spc) & (s < (label + 1) * spc)).all())
    assert bool(((d >= 0) & (d < 2 * vpc)).all())


def _port_state(jstate):
    return {"static": torch.tensor(np.asarray(jstate["static"])),
            "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
            "hals": [from_jax_params(Hallucinator(), p)
                     for p in jstate["hals"]]}


@pytest.mark.parametrize("for_eval", [True, False])
@pytest.mark.parametrize("n_hal", [1, 2])
def test_compose_synthetic_matches_jax(for_eval, n_hal):
    jcfg = js2d.S2DConfig(num_classes=3, spc=2, dpc=2, vpc=1, n_hal=n_hal,
                          frames=4, im_size=(16, 16))
    tcfg = ts2d.S2DConfig(num_classes=3, spc=2, dpc=2, vpc=1, n_hal=n_hal,
                          frames=4, im_size=(16, 16))
    jstate = js2d.init_s2d_state(jax.random.PRNGKey(0), jcfg)
    key = jax.random.PRNGKey(5)
    ref_v, ref_l = js2d.compose_synthetic(key, jstate, jcfg, for_eval)
    draws = (jax_eval_draws(key, tcfg) if for_eval
             else jax_distill_draws(key, 3))
    got_v, got_l = ts2d.compose_synthetic(_port_state(jstate), tcfg, for_eval,
                                          draws=draws)
    assert np.array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=5e-4,
                               atol=5e-4)


def test_init_state_shapes_match_jax():
    jcfg = js2d.S2DConfig(num_classes=3, frames=4, im_size=(16, 12))
    tcfg = ts2d.S2DConfig(num_classes=3, frames=4, im_size=(16, 12))
    jstate = js2d.init_s2d_state(jax.random.PRNGKey(0), jcfg)
    tstate = ts2d.init_s2d_state(torch.Generator().manual_seed(0), tcfg)
    for k in ("static", "dynamic"):
        assert tuple(tstate[k].shape) == jstate[k].shape
    w = tstate["hals"][0]["weight"]
    assert tuple(w.shape) == (3, 4, 3, 3, 3)
    assert float(w.abs().max()) <= 1 / np.sqrt(4 * 27)
    moms = ts2d.init_s2d_momentum(tstate)
    assert float(moms["dynamic"].abs().sum()) == 0.0


def test_hallucinate_casts_to_the_compute_dtype():
    tcfg = ts2d.S2DConfig(num_classes=2, frames=4, im_size=(8, 8))
    st = ts2d.init_s2d_state(torch.Generator().manual_seed(0), tcfg)
    v = ts2d.hallucinate(st["hals"][0], st["static"][:2],
                         st["dynamic"][:, 0], dtype=torch.bfloat16)
    assert v.dtype == torch.bfloat16 and tuple(v.shape) == (2, 4, 8, 8, 3)
