"""The port's MTT pieces against the JAX package's ``distill/mtt.py``.

* ``make_batch_plan``, ``TrajectoryBuffer`` and ``ExpertSampler`` are numpy
  and must agree bit for bit for the same seed.
* One S2D-MTT outer step (3 classes, 64x64x8, syn_steps=2, fp32, frozen
  static, learnable syn_lr) against ``_build_s2d_mtt_step``: the JAX slot
  draws are reproduced from the step's key and handed to the port, and
  dropout is held fixed by a flax Dropout that applies the same numpy
  keep-mask the port receives. Grand loss within 1e-5 relative; outer
  gradients within 1e-5 relative norm (fp32 second-order sums in other
  orders; 2.0e-6 measured on an x86 CPU, with both first stages fused).
* The first-stage kernels' wrappers run their plain versions here; one
  outer step calls each as often as its kernel launches on the card.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_tpu.distill.s2d import S2DConfig as JaxS2DConfig
from video_distillation_tpu.distill.s2d import init_s2d_state as jax_init
from video_distillation_torch.distill import mtt as tmtt
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.distill.s2d import S2DConfig, init_s2d_momentum
from video_distillation_torch.models.hallucinator import Hallucinator
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM, STEPS = 3, 8, 64, 2
LRS = dict(lr_static=100.0, lr_dynamic=0.01, lr_hal=0.01, lr_lr=1e-5)


@pytest.mark.parametrize("n,batch,steps", [(50, 50, 10), (7, 3, 5),
                                           (10, 4, 6), (3, 3, 2)])
def test_make_batch_plan_bit_equal(n, batch, steps):
    for seed in range(3):
        a = jmtt.make_batch_plan(np.random.default_rng(seed), n, batch, steps)
        b = tmtt.make_batch_plan(np.random.default_rng(seed), n, batch, steps)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_batch_plan_leftover_bit_equal():
    left_a, left_b = [np.arange(3), np.arange(3, 5)], [np.arange(3),
                                                        np.arange(3, 5)]
    a = jmtt.make_batch_plan(np.random.default_rng(0), 9, 3, 4, left_a)
    b = tmtt.make_batch_plan(np.random.default_rng(0), 9, 3, 4, left_b)
    assert np.array_equal(a, b)


def test_buffer_format_and_sampler_order_match_jax(tmp_path):
    traj = np.random.default_rng(0).normal(size=(3, 4, 11)).astype(np.float32)
    path = str(tmp_path / "replay_buffer_0.npz")
    jmtt.TrajectoryBuffer(traj).save(path)
    tbuf = tmtt.TrajectoryBuffer.load(path)
    assert np.array_equal(tbuf.trajectories, traj) and tbuf.num_epochs == 4
    jbufs = [jmtt.TrajectoryBuffer(traj), jmtt.TrajectoryBuffer(traj[:2])]
    tbufs = [tmtt.TrajectoryBuffer(traj), tmtt.TrajectoryBuffer(traj[:2])]
    js = jmtt.ExpertSampler(jbufs, np.random.default_rng(5))
    ts = tmtt.ExpertSampler(tbufs, np.random.default_rng(5))
    for _ in range(12):
        a0, a1, ae = js.sample_segment(3, 1)
        b0, b1, be = ts.sample_segment(3, 1)
        assert ae == be and np.array_equal(a0, b0) and np.array_equal(a1, b1)


def test_masked_ce_ignores_padding():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0], [5.0, -5.0]])
    y = torch.tensor([0, 1, 0])
    w = torch.tensor([1.0, 1.0, 0.0])
    ref = torch.nn.functional.cross_entropy(logits[:2], y[:2])
    assert torch.allclose(tmtt.masked_ce(logits, y, w), ref)
    assert float(tmtt.masked_ce(logits, y, torch.zeros(3))) == 0.0


def _fixed_dropout(mask):
    class FixedDropout(flax.linen.Module):
        rate: float
        deterministic: bool = False

        def __call__(self, x):
            if self.deterministic or self.rate == 0:
                return x
            return jnp.where(jnp.asarray(mask), x / (1.0 - self.rate), 0.0)

    return FixedDropout


def _jax_slot_bits(key, steps, batch):
    """The draws of mtt.py:352-362, from the step's own key."""
    k_slots, _ = jax.random.split(key)
    d, s = [], []
    for i in range(steps):
        k1, k2 = jax.random.split(jax.random.fold_in(k_slots, i))
        d.append(np.array(jax.random.randint(k1, (batch,), 0, 2)))
        s.append(np.array(jax.random.randint(k2, (batch,), 0, 2)))
    return np.stack(d), np.stack(s)


@pytest.fixture
def fresh_jax_steps():
    """The JAX step builders are lru-cached: build this test's step with
    the patched Dropout, and leave no patched step behind."""
    jmtt._build_s2d_mtt_step.cache_clear()
    jmtt._build_mtt_core.cache_clear()
    yield
    jmtt._build_s2d_mtt_step.cache_clear()
    jmtt._build_mtt_core.cache_clear()


def rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def test_s2d_mtt_step_matches_jax(monkeypatch, fresh_jax_steps):
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

    # the port, from the same numpy state
    tstate = {"static": torch.tensor(np.asarray(jstate["static"])),
              "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
              "hals": [from_jax_params(Hallucinator(), p)
                       for p in jstate["hals"]]}
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, NC, (IM, IM), F, STEPS,
        S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM)),
        tmtt.S2DHyper(**LRS, train_static=False, train_lr=True),
        "float32", "cpu")
    t_out = step(None, tstate, torch.tensor(0.01), init_s2d_momentum(tstate),
                 torch.zeros(()), torch.tensor(np.asarray(th0)),
                 torch.tensor(np.asarray(th1)), torch.from_numpy(plan),
                 draws=_jax_slot_bits(key, STEPS, NC),
                 keep_masks=torch.from_numpy(np.stack([mask] * STEPS)))

    s2d_items = tuple(sorted(dataclasses.asdict(jcfg).items()))
    jstep = jmtt._build_s2d_mtt_step(
        "ConvNet3D", 3, NC, (IM, IM), F, STEPS, s2d_items, *LRS.values(),
        False, True, "float32")
    moms = jax.tree.map(jnp.zeros_like, jstate)
    # the JAX step donates its state: hand it a copy
    j_out = jstep(key, jax.tree.map(jnp.copy, jstate), jnp.asarray(0.01), moms, jnp.zeros(()), th0,
                  th1, jnp.asarray(plan))
    j_state, j_lr, j_moms, j_mom_lr, j_loss, j_ploss, j_pdist = j_out
    t_state, t_lr, t_moms, t_mom_lr, t_loss, t_ploss, t_pdist, grads = t_out

    assert abs(float(t_loss) / float(j_loss) - 1) <= 1e-5
    assert abs(float(t_pdist) / float(j_pdist) - 1) <= 1e-6
    # momenta start at zero, so after one step they are the gradients
    assert rel_norm(grads["dynamic"], j_moms["dynamic"]) <= 1e-5
    assert torch.equal(t_moms["dynamic"], grads["dynamic"])
    jhal = from_jax_params(Hallucinator(), j_moms["hals"][0])
    for k in ("weight", "bias"):
        assert rel_norm(grads["hals"][0][k], jhal[k]) <= 1e-5, k
    assert abs(float(t_mom_lr) / float(j_mom_lr) - 1) <= 1e-4
    # updated state: dynamic, hallucinator, syn_lr; the frozen static stays
    assert rel_norm(t_state["dynamic"] - tstate["dynamic"],
                    np.asarray(j_state["dynamic"]) -
                    np.asarray(jstate["dynamic"])) <= 1e-4
    jhal_new = from_jax_params(Hallucinator(), j_state["hals"][0])
    for k in ("weight", "bias"):
        assert rel_norm(t_state["hals"][0][k], jhal_new[k]) <= 1e-6, k
    assert abs(float(t_lr) - float(j_lr)) <= 1e-4 * abs(0.01 - float(j_lr))
    assert t_state["static"] is tstate["static"]
    assert "static" not in grads


def test_syn_lr_is_clipped_at_its_minimum():
    """A syn_lr step far past zero leaves syn_lr at 0.001, its floor
    (distill_baseline.py:283)."""
    from video_distillation_torch.distill.s2d import init_s2d_state
    cfg = S2DConfig(num_classes=2, frames=8, im_size=(64, 64))
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg)
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, 2, (64, 64), 8, 1, cfg,
        tmtt.S2DHyper(100.0, 0.0, 0.0, 0.0, False, True), "float32", "cpu")

    def run():
        return step(torch.Generator().manual_seed(1), state, torch.tensor(0.01),
                    init_s2d_momentum(state), torch.zeros(()), t0, t1,
                    torch.tensor([[0, 1]]))

    g_lr = float(run()[7]["syn_lr"])
    assert g_lr != 0.0
    step.hyper = dataclasses.replace(step.hyper, lr_lr=1e9 * np.sign(g_lr))
    assert float(run()[1]) == pytest.approx(0.001)


def test_trainable_static_gets_its_gradient_and_update():
    """With train_static (the no_train_static=False presets) the static
    memory is a differentiated input: it gets a finite gradient through
    the gather and hal_dgrad's static cotangent, and the SGD step with
    zero momentum moves it by lr_static times that gradient."""
    from video_distillation_torch.distill.s2d import init_s2d_state
    cfg = S2DConfig(num_classes=2, frames=8, im_size=(64, 64))
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg)
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, 2, (64, 64), 8, 1, cfg,
        tmtt.S2DHyper(100.0, 0.01, 0.01, 1e-5, True, True), "float32", "cpu")
    out = step(torch.Generator().manual_seed(1), state, torch.tensor(0.01),
               init_s2d_momentum(state), torch.zeros(()), t0, t1,
               torch.tensor([[0, 1]]))
    g = out[7]["static"]
    assert g.shape == state["static"].shape and torch.isfinite(g).all()
    assert float(g.abs().max()) > 0
    assert torch.equal(out[2]["static"], g)
    torch.testing.assert_close(out[0]["static"], state["static"] - 100.0 * g,
                               rtol=0, atol=0)


def _count_first_stage_calls(monkeypatch):
    """Count the calls of each first-stage wrapper's plain version (what
    the wrapper runs on the CPU, once per kernel launch on the card)."""
    from video_distillation_torch.ops import phase_trio, s2d2_move
    counts = dict.fromkeys(("pack", "unpack", "phase_argmax", "phase_select",
                            "phase_scatter"), 0)
    for mod, key in ((s2d2_move, "pack"), (s2d2_move, "unpack"),
                     (phase_trio, "phase_argmax"), (phase_trio, "phase_select"),
                     (phase_trio, "phase_scatter")):
        fn = getattr(mod, f"{key}_plain")

        def counted(*args, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, f"{key}_plain", counted)
    return counts


def test_first_stage_calls_per_outer_step(monkeypatch):
    """One S2D-MTT outer step of syn_steps S: pack and phase_argmax once per
    inner forward; phase_scatter in each inner backward and again in the
    outer backward through the forward; phase_select and unpack once per
    inner step in the outer backward. A first-order step (evaluation,
    experts) and a no-grad forward (the test pass) run no unpack."""
    from video_distillation_torch.distill.s2d import init_s2d_state
    steps = 3
    counts = _count_first_stage_calls(monkeypatch)
    cfg = S2DConfig(num_classes=2, frames=8, im_size=(64, 64))
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg)
    _, t0 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    _, t1 = tmtt.flat_param_template("ConvNet3D", 3, 2, (64, 64), 8, gen)
    step = tmtt.S2DMTTStep(
        "ConvNet3D", 3, 2, (64, 64), 8, steps, cfg,
        tmtt.S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True), "float32", "cpu")
    step(torch.Generator().manual_seed(1), state, torch.tensor(0.01),
         init_s2d_momentum(state), torch.zeros(()), t0, t1,
         torch.tensor([[0, 1]] * steps))
    assert counts == {"pack": steps, "phase_argmax": steps,
                      "phase_scatter": 2 * steps, "phase_select": steps,
                      "unpack": steps}

    counts.update(dict.fromkeys(counts, 0))
    theta = t0.clone().requires_grad_(True)
    x = torch.randn(2, 8, 64, 64, 3, generator=gen)
    ce = step.core.ce(theta, x, torch.tensor([0, 1]), torch.ones(2),
                      generator=gen)
    torch.autograd.grad(ce, theta)
    assert counts == {"pack": 1, "phase_argmax": 1, "phase_scatter": 1,
                      "phase_select": 0, "unpack": 0}
    counts.update(dict.fromkeys(counts, 0))
    with torch.no_grad():
        step.core.ce(theta, x, torch.tensor([0, 1]), torch.ones(2),
                     generator=gen)
    assert counts == {"pack": 1, "phase_argmax": 1, "phase_scatter": 0,
                      "phase_select": 0, "unpack": 0}
