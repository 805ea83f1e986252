"""``second_order='remat'``: MTT's inner steps rematerialised in the outer
backward (``distill/mtt.py``'s ``_RematStep``).

* One S2D-MTT outer step with remat against the JAX package's
  ``_build_s2d_mtt_step(..., "remat")`` (``jax.checkpoint`` on the inner
  step) at ``test_torch_mtt.py``'s shapes (3 classes, 64x64x8,
  syn_steps=2, fp32), with JAX's slot draws and dropout masks: grand loss
  and outer gradients within 1e-5 relative.
* Raw ``MTTStep`` with remat against 'full' in fp64: within 1e-10, with
  the masks handed in and with dropout drawn from a ``torch.Generator``
  (remat draws each step's mask before its region, so its recompute sees
  the mask the forward saw).
* The first-stage wrappers' calls per outer step, and ``--second_order
  remat`` through both MTT drivers against 'full'.
"""

import dataclasses

import jax
import jax.numpy as jnp
import flax.linen
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_tpu.distill.s2d import S2DConfig as JaxS2DConfig
from video_distillation_tpu.distill.s2d import init_s2d_state as jax_init
from video_distillation_torch.distill import mtt as tmtt
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.distill.s2d import (S2DConfig,
                                                  init_s2d_momentum,
                                                  init_s2d_state)
from video_distillation_torch.drivers import distill_baseline, distill_s2d
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.utils.logging import MetricLogger
from test_torch_mtt import (LRS, _count_first_stage_calls,  # noqa: F401
                            _fixed_dropout, _jax_slot_bits, fresh_jax_steps,
                            rel_norm)
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM, STEPS = 3, 8, 64, 2


def test_s2d_mtt_remat_step_matches_jax(monkeypatch, fresh_jax_steps):
    rng = np.random.default_rng(0)
    mask = rng.random((NC, 1, 1, 1, 128)) < 0.5
    monkeypatch.setattr(flax.linen, "Dropout", _fixed_dropout(mask))

    jcfg = JaxS2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
    jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    _, _, th0, _ = jmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                            seed=0)
    _, _, th1, _ = jmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                            seed=1)
    plan = jmtt.make_batch_plan(np.random.default_rng(1), NC, NC, STEPS)
    key = jax.random.PRNGKey(2)

    tstate = {"static": torch.tensor(np.asarray(jstate["static"])),
              "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
              "hals": [from_jax_params(Hallucinator(), p)
                       for p in jstate["hals"]]}
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, NC, (IM, IM), F, STEPS,
        S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM)),
        tmtt.S2DHyper(**LRS, train_static=False, train_lr=True),
        "float32", "cpu", second_order="remat")
    t_out = step(None, tstate, torch.tensor(0.01), init_s2d_momentum(tstate),
                 torch.zeros(()), torch.tensor(np.asarray(th0)),
                 torch.tensor(np.asarray(th1)), torch.from_numpy(plan),
                 draws=_jax_slot_bits(key, STEPS, NC),
                 keep_masks=torch.from_numpy(np.stack([mask] * STEPS)))

    s2d_items = tuple(sorted(dataclasses.asdict(jcfg).items()))
    jstep = jmtt._build_s2d_mtt_step(
        "ConvNet3D", 3, NC, (IM, IM), F, STEPS, s2d_items, *LRS.values(),
        False, True, "float32", "remat")
    moms = jax.tree.map(jnp.zeros_like, jstate)
    j_out = jstep(key, jax.tree.map(jnp.copy, jstate), jnp.asarray(0.01),
                  moms, jnp.zeros(()), th0, th1, jnp.asarray(plan))
    _, j_lr, j_moms, j_mom_lr, j_loss, _, j_pdist = j_out
    _, t_lr, _, t_mom_lr, t_loss, _, t_pdist, grads = t_out

    assert abs(float(t_loss) / float(j_loss) - 1) <= 1e-5
    assert abs(float(t_pdist) / float(j_pdist) - 1) <= 1e-6
    # momenta start at zero, so after one step they are the gradients
    assert rel_norm(grads["dynamic"], j_moms["dynamic"]) <= 1e-5
    jhal = from_jax_params(Hallucinator(), j_moms["hals"][0])
    for k in ("weight", "bias"):
        assert rel_norm(grads["hals"][0][k], jhal[k]) <= 1e-5, k
    assert abs(float(t_mom_lr) / float(j_mom_lr) - 1) <= 1e-5


def _raw_step(mode, masks, generator_seed):
    """One raw MTT outer step, fp64 on the CPU, in ``mode``; dropout from
    ``masks`` or, if None, from a generator seeded ``generator_seed``."""
    gen = torch.Generator().manual_seed(0)
    syn = torch.randn(NC, F, IM, IM, 3, generator=gen, dtype=torch.float64)
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    plan = torch.as_tensor(tmtt.make_batch_plan(np.random.default_rng(1), NC,
                                                NC, STEPS))
    step = tmtt.MTTStep("ConvNet3D", 3, NC, (IM, IM), F, STEPS, 100.0, 1e-5,
                        True, "float64", "cpu", second_order=mode)
    return step(torch.Generator().manual_seed(generator_seed), syn,
                torch.arange(NC), torch.tensor(0.01, dtype=torch.float64),
                torch.zeros_like(syn), torch.zeros((), dtype=torch.float64),
                t0.double(), t1.double(), plan, keep_masks=masks)


@pytest.mark.parametrize("dropout", ["handed", "generator"])
def test_raw_mtt_remat_equals_full_in_fp64(dropout):
    masks = (torch.rand(STEPS, NC, 1, 1, 1, 128,
                        generator=torch.Generator().manual_seed(3)) < 0.5
             if dropout == "handed" else None)
    full, remat = (_raw_step(mode, masks, 4) for mode in ("full", "remat"))
    assert abs(float(remat[4]) / float(full[4]) - 1) <= 1e-10
    for k in ("images", "syn_lr"):
        assert rel_norm(remat[7][k], full[7][k]) <= 1e-10, k
    if dropout == "generator":
        # the generator's masks matter: another seed moves the gradient
        other = _raw_step("remat", None, 5)
        assert rel_norm(other[7]["images"], full[7]["images"]) > 1e-3


def test_unknown_second_order_raises():
    with pytest.raises(ValueError, match="unknown second_order mode: nope"):
        tmtt.MTTStep("ConvNet3D", 3, NC, (IM, IM), F, STEPS, 100.0, 1e-5,
                     True, "float32", "cpu", second_order="nope")


def test_first_stage_calls_per_outer_step_remat(monkeypatch):
    """Under remat each inner step runs its forward and first-order
    backward twice (the forward pass and the recompute) and the recompute's
    backward once: per inner step pack and phase_argmax twice,
    phase_scatter three times, phase_select and unpack once."""
    steps = 3
    counts = _count_first_stage_calls(monkeypatch)
    cfg = S2DConfig(num_classes=2, frames=8, im_size=(64, 64))
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg)
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, 2, (64, 64), 8, steps, cfg,
        tmtt.S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True), "float32", "cpu",
        second_order="remat")
    step(torch.Generator().manual_seed(1), state, torch.tensor(0.01),
         init_s2d_momentum(state), torch.zeros(()), t0, t1,
         torch.tensor([[0, 1]] * steps))
    assert counts == {"pack": 2 * steps, "phase_argmax": 2 * steps,
                      "phase_scatter": 3 * steps, "phase_select": steps,
                      "unpack": steps}


DS = f"synthetic_c{NC}_n2_t1_f{F}_im{IM}"


@pytest.fixture(scope="module")
def buffer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("remat_buffers")
    thetas = [tmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                       torch.Generator().manual_seed(s),
                                       "cpu")[1] for s in (0, 1)]
    tmtt.TrajectoryBuffer(torch.stack(thetas).numpy()[None]).save(
        str(d / "replay_buffer_0.npz"))
    return str(d)


def _drive(kind, mode, buffer_dir, save_path):
    """Two outer steps of raw MTT or S2D-MTT through the driver's CLI, fp32
    on the CPU, no evaluation; returns what the steps learned."""
    argv = ["--device", "cpu", "--dataset", DS, "--save_path", str(save_path),
            "--buffer_path", buffer_dir, "--syn_steps", str(STEPS),
            "--max_start_epoch", "1", "--Iteration", "1", "--startIt", "100",
            "--compute_dtype", "float32", "--second_order", mode]
    if kind == "S2D-MTT":
        holder = distill_s2d.main(["--preset", "s2d_MTT_ms", *argv])
        state = holder["state"]
        return [state["dynamic"], state["hals"][0]["weight"], holder["syn_lr"]]
    syn, _, syn_lr = distill_baseline.main(["--preset", "MTT", *argv],
                                           logger=MetricLogger(quiet=True))
    return [syn, syn_lr]


@pytest.mark.parametrize("kind", ["MTT", "S2D-MTT"])
def test_drivers_run_remat_as_full(kind, buffer_dir, tmp_path):
    full = _drive(kind, "full", buffer_dir, tmp_path / "full")
    remat = _drive(kind, "remat", buffer_dir, tmp_path / "remat")
    for a, b in zip(remat, full):
        assert torch.isfinite(a).all()
        assert rel_norm(a, b) <= 1e-5
