"""The port's S2D-MTT driver (``drivers/distill_s2d.py``) on the CPU.

It reads an expert buffer written by the JAX package's
``TrajectoryBuffer.save`` from a θ made by the JAX package's
``flat_param_template``, so the ``.npz`` format and the flat order are
shared. The checkpoint round trip brings back ``mom_lr`` and the numpy RNG
state, and the paths that are not ported yet raise naming their ROADMAP
item. A run that reaches evaluation iterations trains fresh nets at the
learned ``syn_lr``, logs finite accuracies and writes artifacts that the
JAX package reads (``hal_{it}.npz`` in its keys and layout).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_torch.config import get_preset
from video_distillation_torch.drivers.common import (load_data,
                                                     parse_config_args)
from video_distillation_torch.distill.s2d import init_s2d_momentum
from video_distillation_torch.drivers.distill_s2d import build_s2d, run
from video_distillation_torch.utils.checkpoint import (restore_state,
                                                       save_state)
from video_distillation_torch.utils.logging import MetricLogger
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM = 3, 8, 64


@pytest.fixture(scope="module")
def jax_buffer_dir(tmp_path_factory):
    """One expert of two epochs, from two JAX inits, saved by JAX."""
    d = tmp_path_factory.mktemp("buffers")
    thetas = [np.asarray(jmtt.flat_param_template(
        "ConvNet3D", 3, NC, (IM, IM), F, seed=s)[2]) for s in (0, 1)]
    jmtt.TrajectoryBuffer(np.stack(thetas)[None]).save(
        str(d / "replay_buffer_0.npz"))
    return str(d)


def _cfg(buffer_dir, save_dir, **kw):
    cfg = get_preset("s2d_MTT_ms")
    cfg.s2d = True
    cfg.dataset = f"synthetic_c{NC}_n2_t1_f{F}_im{IM}"
    cfg.buffer_path, cfg.save_path = buffer_dir, str(save_dir)
    cfg.syn_steps, cfg.Iteration, cfg.max_start_epoch = 2, 1, 1
    cfg.device = "cpu"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _run(cfg):
    seen = []
    holder = run(cfg, load_data(cfg), MetricLogger(quiet=True),
                 step_hook=lambda it, out: seen.append((it, out)))
    return holder, seen


def test_two_mtt_iterations_from_a_jax_buffer(jax_buffer_dir, tmp_path):
    cfg = _cfg(jax_buffer_dir, tmp_path)
    holder, seen = _run(cfg)
    assert [it for it, _ in seen] == [0, 1]
    for _, out in seen:
        loss, grads = out[4], out[7]
        assert math.isfinite(float(loss)) and float(loss) > 0
        for g in (grads["dynamic"], grads["syn_lr"],
                  *grads["hals"][0].values()):
            assert torch.isfinite(g).all()
        assert float(out[1]) >= 0.001
    st = holder["state"]
    assert st["dynamic"].shape == (NC, 2, F, IM, IM, 1)
    assert st["static"].shape == (NC * 2, IM, IM, 3)
    assert st["dynamic"].device.type == "cpu"
    # the frozen static is never updated; the dynamic memory is
    fresh = build_s2d(cfg, load_data(cfg).meta, "cpu")[1]
    assert torch.equal(st["static"], fresh["static"])
    assert not torch.equal(st["dynamic"], fresh["dynamic"])


def test_checkpoint_restores_mom_lr_and_host_rng(tmp_path):
    state = {"state": {"static": torch.randn(2, 4, 4, 3),
                       "dynamic": torch.randn(1, 2, 3, 4, 4, 1),
                       "hals": [{"weight": torch.randn(3, 4, 3, 3, 3),
                                 "bias": torch.randn(3)}]},
             "moms": {"dynamic": torch.randn(1, 2, 3, 4, 4, 1)},
             "syn_lr": torch.tensor(0.02), "mom_lr": torch.tensor(-3.5)}
    rng = np.random.default_rng(7)
    rng.integers(0, 10, 5)
    save_state(str(tmp_path), state, 1000, rng)
    expect = rng.integers(0, 1 << 30, 8)
    got, step, rng_state = restore_state(str(tmp_path), device="cpu")
    assert step == 1000
    assert float(got["mom_lr"]) == -3.5 and float(got["syn_lr"]) == \
        pytest.approx(0.02)
    assert torch.equal(got["state"]["hals"][0]["weight"],
                       state["state"]["hals"][0]["weight"])
    fresh = np.random.default_rng(0)
    fresh.bit_generator.state = rng_state
    assert np.array_equal(fresh.integers(0, 1 << 30, 8), expect)


def test_run_resumes_from_its_checkpoint(jax_buffer_dir, tmp_path):
    """A run with a checkpoint at iteration 5 takes only iteration 6, from
    the saved syn_lr and mom_lr (lr_lr = 0 holds syn_lr where it was)."""
    cfg = _cfg(jax_buffer_dir, tmp_path, Iteration=6, lr_lr=0.0)
    _, st = build_s2d(cfg, load_data(cfg).meta, "cpu")
    ckpt = os.path.join(cfg.save_path, f"S2D_multis_MTT_{cfg.dataset}",
                        "ckpt")
    save_state(ckpt, {"state": st, "moms": init_s2d_momentum(st),
                      "syn_lr": torch.tensor(0.02),
                      "mom_lr": torch.tensor(5.0)}, 5,
               np.random.default_rng(3))
    holder, seen = _run(cfg)
    assert [it for it, _ in seen] == [6]
    out = seen[0][1]
    assert float(holder["syn_lr"]) == pytest.approx(0.02)
    assert float(out[3]) == pytest.approx(0.9 * 5.0 + float(out[7]["syn_lr"]))


@pytest.mark.parametrize("fields,error,match", [
    ({"method": "DM", "shard_store": True}, NotImplementedError, "A.16"),
    ({"second_order": "remat"}, NotImplementedError, "remat"),
    ({"device": "cuda"}, RuntimeError, "CUDA is not available"),
])
def test_unported_paths_raise(jax_buffer_dir, tmp_path, fields, error, match):
    if "device" in fields and torch.cuda.is_available():
        pytest.skip("the CUDA-missing error needs a host without CUDA")
    cfg = _cfg(jax_buffer_dir, tmp_path, **fields)
    with pytest.raises(error, match=match):
        run(cfg, load_data(cfg), MetricLogger(quiet=True))


class RecordingLogger(MetricLogger):
    def __init__(self):
        super().__init__(quiet=True)
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))


@pytest.fixture(scope="module")
def evaluated_run(jax_buffer_dir, tmp_path_factory):
    """Two outer steps with an evaluation at iterations 0 and 1 (1 fresh
    net of 2 epochs each), then the run's outputs."""
    out = tmp_path_factory.mktemp("evaluated")
    cfg = _cfg(jax_buffer_dir, out, startIt=0, eval_it=1, num_eval=1,
               epoch_eval_train=1)
    logger = RecordingLogger()
    holder = run(cfg, load_data(cfg), logger)
    return cfg, holder, logger.records, os.path.join(
        str(out), f"S2D_multis_MTT_{cfg.dataset}")


def test_evaluation_logs_accuracies_and_writes_artifacts(evaluated_run):
    cfg, _, records, out_dir = evaluated_run
    accs = [(step, m) for step, m in records if "Accuracy/ConvNet3D" in m]
    assert [step for step, _ in accs] == [0, 1]
    for _, m in accs:
        for k in ("Accuracy", "Max_Accuracy", "Std", "Max_Std"):
            v = m[f"{k}/ConvNet3D"]
            assert math.isfinite(v) and 0.0 <= v <= 1.0, (k, v)
    # iteration 0 always saves (it % 1000 == 0); a first accuracy above 0 is
    # also a new best
    files = set(os.listdir(out_dir))
    assert {"dynamic_0.npy", "hal_0.npz"} <= files
    assert "images_0.npy" not in files  # the static memory is frozen
    assert np.load(os.path.join(out_dir, "dynamic_0.npy")).shape == \
        (NC * 2, F, IM, IM, 1)
    pngs = set(os.listdir(os.path.join(out_dir, "png")))
    assert {"static_000000.png", "dynamic_000000.png",
            "videos_000000.png"} <= pngs


def test_evaluation_trains_at_the_learned_syn_lr(jax_buffer_dir, tmp_path,
                                                 monkeypatch):
    """ROADMAP C.3: the evaluation nets train at the current learned syn_lr,
    not at lr_net."""
    from video_distillation_torch.drivers import common
    seen = []
    real = common.evaluate_many

    def spy(generator, num_eval, syn_images, syn_labels, data, cfg, *a, **kw):
        seen.append(cfg.lr_net)
        return real(generator, num_eval, syn_images, syn_labels, data, cfg,
                    *a, **kw)

    monkeypatch.setattr(common, "evaluate_many", spy)
    cfg = _cfg(jax_buffer_dir, tmp_path, startIt=1, eval_it=1, num_eval=1,
               epoch_eval_train=0, lr_net=0.5)
    holder, steps = _run(cfg)
    assert len(seen) == 1 and seen[0] != 0.5
    assert seen[0] == pytest.approx(float(steps[0][1][1]))


def test_hal_artifact_recomposes_in_jax(evaluated_run):
    """hal_{it}.npz holds the JAX package's keys and layout: its loader
    restores the hallucinator of iteration 0 (the seeded init, before any
    step), and JAX composes the same videos from it as the port does."""
    from video_distillation_tpu.distill import s2d as js2d
    from video_distillation_tpu.utils.checkpoint import load_pytree_artifact
    from video_distillation_torch.distill.s2d import hallucinate

    cfg, _, _, out_dir = evaluated_run
    path = os.path.join(out_dir, "hal_0.npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["[0]['bias']", "[0]['kernel']"]
    template = [{"kernel": np.zeros((3, 3, 3, 4, 3), np.float32),
                 "bias": np.zeros(3, np.float32)}]
    hals = load_pytree_artifact(path, template)
    st0 = build_s2d(cfg, load_data(cfg).meta, "cpu")[1]
    static = st0["static"][:2]
    dynamic = torch.from_numpy(np.load(os.path.join(out_dir, "dynamic_0.npy"))[:2])
    ref = js2d.hallucinate(hals[0], jnp.asarray(static.numpy()),
                           jnp.asarray(dynamic.numpy()))
    got = hallucinate(st0["hals"][0], static, dynamic)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=5e-4)


def test_cli_device_flag_defaults_to_cuda():
    assert parse_config_args("t", []).device == "cuda"
    cfg = parse_config_args("t", ["--preset", "s2d_MTT_ms", "--device", "cpu",
                                  "--compute_dtype", "bfloat16"])
    assert cfg.device == "cpu" and cfg.compute_dtype == "bfloat16"
    assert cfg.method == "MTT" and cfg.syn_steps == 10
