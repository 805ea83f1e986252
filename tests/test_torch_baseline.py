"""The port's baselines against the JAX package's, on the CPU in fp32, at
the shapes of ``tests/test_torch_mtt.py`` (3 classes, 64x64x8, ConvNet3D),
and its baseline drivers at a toy size.

* One raw MTT outer step (syn_steps=2, learnable syn_lr) against
  ``_build_mtt_step``, dropout held fixed by a flax Dropout that applies the
  numpy keep-mask the port receives, at the tolerances of
  ``test_s2d_mtt_step_matches_jax``: grand loss within 1e-5 relative, the
  images' outer gradient within 1e-5 relative norm, ``mom_lr`` (momentum
  0.5, from a start where 0.9 would differ) within 1e-4 relative and the
  updated syn_lr within 1e-4 of its change.
* Coresets: the features within 1e-5 of the largest |feature| of JAX's
  ``_build_embed_fn`` on the same net; ``_kcenter`` and ``_herding`` equal
  to JAX's on the same features; ``select_coreset`` picks the same clips
  (bit-equal synthetic sets).
* The drivers through their CLIs (``--device cpu``): ``distill_baseline``
  DM and MTT and ``distill_s2d --preset s2d_DM_ms`` write their artifacts,
  and a run resumed from a checkpoint ends bit-equal to an uninterrupted
  one; ``distill_coreset`` picks clips of each class and logs finite
  accuracies; other methods raise, and so does a ``mesh_shape`` that
  does not hold the launch's ranks.
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.data import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import coreset as jcoreset
from video_distillation_tpu.distill import mtt as jmtt
from video_distillation_torch.data.synthetic import make_synthetic_video_data
from video_distillation_torch.distill import coreset, dm
from video_distillation_torch.distill import mtt as tmtt
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.drivers import (common, distill_baseline,
                                              distill_coreset, distill_s2d)
from video_distillation_torch.models.registry import create_model
from video_distillation_torch.utils.logging import MetricLogger
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM, STEPS = 3, 8, 64, 2


def rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def _fixed_dropout(mask):
    class FixedDropout(flax.linen.Module):
        rate: float
        deterministic: bool = False

        def __call__(self, x):
            if self.deterministic or self.rate == 0:
                return x
            return jnp.where(jnp.asarray(mask), x / (1.0 - self.rate), 0.0)

    return FixedDropout


@pytest.fixture
def fresh_jax_steps():
    """The JAX step builders are lru-cached: build this test's step with
    the patched Dropout, and leave no patched step behind."""
    jmtt._build_mtt_step.cache_clear()
    jmtt._build_mtt_core.cache_clear()
    yield
    jmtt._build_mtt_step.cache_clear()
    jmtt._build_mtt_core.cache_clear()


def test_mtt_step_matches_jax(monkeypatch, fresh_jax_steps):
    rng = np.random.default_rng(0)
    mask = rng.random((NC, 1, 1, 1, 128)) < 0.5
    monkeypatch.setattr(flax.linen, "Dropout", _fixed_dropout(mask))
    syn = rng.normal(size=(NC, F, IM, IM, 3)).astype(np.float32)
    labels = np.arange(NC, dtype=np.int32)
    th0, th1 = (np.asarray(jmtt.flat_param_template(
        "ConvNet3D", 3, NC, (IM, IM), F, seed=s)[2]) for s in (0, 1))
    plan = jmtt.make_batch_plan(np.random.default_rng(1), NC, NC, STEPS)
    lr_img, lr_lr, syn_lr, mom_lr = 100.0, 1e-5, 0.01, 2e3

    jstep = jmtt._build_mtt_step("ConvNet3D", 3, NC, (IM, IM), F, STEPS,
                                 lr_img, lr_lr, True, "float32")
    j_syn, j_lr, j_mom, j_mom_lr, j_loss, _, j_pdist = jstep(
        jax.random.PRNGKey(2), jnp.asarray(syn), jnp.asarray(labels),
        jnp.asarray(syn_lr), jnp.zeros(syn.shape), jnp.asarray(mom_lr),
        jnp.asarray(th0), jnp.asarray(th1), jnp.asarray(plan))

    step = tmtt.MTTStep("ConvNet3D", 3, NC, (IM, IM), F, STEPS, lr_img, lr_lr,
                        True, "float32", "cpu")
    out = step(None, torch.from_numpy(syn), torch.from_numpy(labels).long(),
               torch.tensor(syn_lr), torch.zeros(syn.shape),
               torch.tensor(mom_lr), torch.from_numpy(th0),
               torch.from_numpy(th1), torch.from_numpy(plan),
               keep_masks=torch.from_numpy(np.stack([mask] * STEPS)))
    t_syn, t_lr, t_mom, t_mom_lr, t_loss, _, t_pdist, grads = out

    assert abs(float(t_loss) / float(j_loss) - 1) <= 1e-5
    assert abs(float(t_pdist) / float(j_pdist) - 1) <= 1e-6
    # the momentum starts at zero: after one step it is the gradient
    assert rel_norm(grads["images"], j_mom) <= 1e-5
    assert torch.equal(t_mom, grads["images"])
    assert rel_norm(t_syn, j_syn) <= 1e-5
    # syn_lr's momentum is 0.5 (distill_baseline.py:107-108), not S2D's 0.9
    g_lr = float(grads["syn_lr"])
    assert abs(0.4 * mom_lr) > 1e-2 * abs(0.5 * mom_lr + g_lr)
    assert abs(float(t_mom_lr) / float(j_mom_lr) - 1) <= 1e-4
    assert float(t_mom_lr) == pytest.approx(0.5 * mom_lr + g_lr, rel=1e-6)
    assert abs(float(t_lr) - float(j_lr)) <= 1e-4 * abs(syn_lr - float(j_lr))
    assert float(t_lr) >= 0.001


@pytest.fixture(scope="module")
def stores():
    kw = dict(num_classes=NC, clips_per_class=6, test_per_class=1, frames=F,
              im_size=(IM, IM), name="coreset-parity")
    return jax_synthetic(**kw).train, make_synthetic_video_data(**kw).train


@pytest.fixture(scope="module")
def nets():
    """A JAX ConvNet3D's parameters, and the port's net carrying them."""
    embed_fn, model_def = jcoreset._build_embed_fn("ConvNet3D", 3, NC,
                                                   (IM, IM), F)
    key = jax.random.PRNGKey(5)
    params = model_def.init({"params": key, "dropout": key},
                            jnp.zeros((1, F, IM, IM, 3)), train=False)["params"]
    model = create_model("ConvNet3D", 3, NC, (IM, IM), F, device="cpu")
    return embed_fn, params, model, from_jax_params(model, params)


def test_coreset_features_match_jax(stores, nets):
    jst, pst = stores
    embed_fn, params, model, tparams = nets
    idx = np.arange(len(pst))
    mean, std = dm.norm_stats(pst.meta, "cpu")
    got = dm.real_features(model, tparams, pst, pst.device_clips("cpu"),
                           torch.from_numpy(idx), mean, std, torch.float32,
                           chunk=5).numpy()
    ref = np.asarray(embed_fn(params, jnp.asarray(jst.clips), mean.numpy(),
                              std.numpy()))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("ipc", [1, 3, 6])
def test_greedy_selectors_match_jax(ipc):
    feats = np.random.default_rng(ipc).normal(size=(6, 40)).astype(np.float32)
    assert coreset._kcenter(feats, ipc) == jcoreset._kcenter(feats, ipc)
    assert coreset._herding(feats, ipc) == jcoreset._herding(feats, ipc)


@pytest.mark.parametrize("method", ["k-center", "herding"])
def test_select_coreset_picks_the_jax_clips(stores, nets, method):
    jst, pst = stores
    _, params, _, tparams = nets
    jsyn, jlab = jcoreset.select_coreset(None, jst, "ConvNet3D", 2, method, F,
                                         params=params)
    syn, lab = coreset.select_coreset(None, pst, "ConvNet3D", 2, method, F,
                                      params=tparams, device="cpu")
    np.testing.assert_array_equal(syn.numpy(), np.asarray(jsyn))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


# ----------------------------------------------------------------------
# the drivers, on the CPU at a toy size
# ----------------------------------------------------------------------

DS = f"synthetic_c{NC}_n4_t1_f{F}_im{IM}"


@pytest.fixture(scope="module")
def buffer_dir(tmp_path_factory):
    """One expert of two epochs (two port inits), for MTT."""
    d = tmp_path_factory.mktemp("baseline_buffers")
    thetas = [tmtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                       torch.Generator().manual_seed(s),
                                       "cpu")[1] for s in (0, 1)]
    tmtt.TrajectoryBuffer(torch.stack(thetas).numpy()[None]).save(
        str(d / "replay_buffer_0.npz"))
    return str(d)


def _argv(kind, save_path, iterations, buffer_dir):
    base = ["--device", "cpu", "--dataset", DS, "--save_path", str(save_path),
            "--Iteration", str(iterations), "--startIt", "0", "--eval_it",
            "100", "--num_eval", "1", "--epoch_eval_train", "1"]
    if kind == "MTT":
        return ["--preset", "MTT", "--buffer_path", buffer_dir, "--syn_steps",
                str(STEPS), "--max_start_epoch", "1", *base]
    preset = {"DM": "DM", "S2D-DM": "s2d_DM_ms"}[kind]
    return ["--preset", preset, "--batch_real", "2", *base]


def _drive(kind, argv):
    if kind == "S2D-DM":
        holder = distill_s2d.main(argv)
        return [holder["state"]["dynamic"], holder["state"]["hals"][0]["weight"]]
    out = distill_baseline.main(argv, logger=MetricLogger(quiet=True))
    if kind == "DM":
        return [out.syn_images, out.momentum]
    return [out[0], out[2]]


OUT_DIRS = {"DM": "Baseline_DM", "MTT": "Baseline_MTT",
            "S2D-DM": "S2D_multis_DM"}


@pytest.mark.parametrize("kind", ["DM", "MTT", "S2D-DM"])
def test_driver_writes_artifacts_and_resumes_exactly(kind, buffer_dir,
                                                     tmp_path, monkeypatch):
    """Iterations 0-2 in one run, against 0-1 then a run resumed from the
    checkpoint of iteration 1 (checkpoints every iteration here)."""
    monkeypatch.setattr(common, "CHECKPOINT_EVERY", 1)
    whole = _drive(kind, _argv(kind, tmp_path / "whole", 2, buffer_dir))
    _drive(kind, _argv(kind, tmp_path / "cut", 1, buffer_dir))
    resumed = _drive(kind, _argv(kind, tmp_path / "cut", 2, buffer_dir))
    for a, b in zip(whole, resumed):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()

    out_dir = tmp_path / "whole" / f"{OUT_DIRS[kind]}_{DS}"
    files = set(os.listdir(out_dir))
    want = ({"dynamic_0.npy", "hal_0.npz"} if kind == "S2D-DM"
            else {"images_0.npy"})
    assert want <= files and "ckpt" in files
    if kind != "S2D-DM":
        img = np.load(out_dir / "images_0.npy")
        assert img.shape == (NC, F, IM, IM, 3) and np.isfinite(img).all()
        assert os.listdir(out_dir / "png") == ["videos_000000.png"]


def test_s2d_dm_evaluates_at_the_untouched_syn_lr(monkeypatch, tmp_path,
                                                  buffer_dir):
    """S2D-DM evaluates at syn_lr, which DM never trains: lr_teacher."""
    seen = []
    real = common.evaluate_many

    def spy(generator, num_eval, syn_images, syn_labels, data, cfg, *a, **kw):
        seen.append(cfg.lr_net)
        return real(generator, num_eval, syn_images, syn_labels, data, cfg,
                    *a, **kw)

    monkeypatch.setattr(common, "evaluate_many", spy)
    distill_s2d.main(_argv("S2D-DM", tmp_path, 0, buffer_dir)
                     + ["--lr_teacher", "0.03", "--epoch_eval_train", "0"])
    assert seen == [pytest.approx(0.03)]


@pytest.mark.parametrize("method", ["k-center", "herding"])
def test_coreset_driver(method):
    syn, labels, accs = distill_coreset.main(
        ["--device", "cpu", "--dataset", DS, "--method", method, "--ipc", "2",
         "--num_eval", "1", "--epoch_eval_train", "1"],
        logger=MetricLogger(quiet=True))
    assert syn.shape == (2 * NC, F, IM, IM, 3)
    assert labels.tolist() == [0, 0, 1, 1, 2, 2]
    data = make_synthetic_video_data(
        **{"num_classes": NC, "clips_per_class": 4, "test_per_class": 1,
           "frames": F, "im_size": (IM, IM)})
    store = data.train
    normed = store.normalize(torch.from_numpy(store.clips))
    for v, c in zip(syn, labels.tolist()):
        hits = [i for i in range(len(store)) if torch.equal(normed[i], v)]
        assert hits and all(store.labels[i] == c for i in hits)
    (mean, std), = accs.values()
    assert 0.0 <= mean <= 1.0 and np.isfinite(std)


def test_mesh_shape_must_hold_the_launch(tmp_path):
    # a mesh of 4 devices in a launch of one rank (no process group here)
    cfg = distill_baseline.parse_config_args(
        "", ["--device", "cpu", "--preset", "DM", "--dataset", DS,
             "--save_path", str(tmp_path)])
    cfg.mesh_shape = (2, 2)
    with pytest.raises(ValueError, match="mesh_shape"):
        distill_baseline.run_dm(cfg, None, MetricLogger(quiet=True))


@pytest.mark.parametrize("flags,match", [
    (["--method", "FRePo"], "FRePo"),
])
def test_baseline_paths_not_ported_raise(flags, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        distill_baseline.main(["--device", "cpu", "--dataset", DS,
                               "--save_path", str(tmp_path), *flags],
                              logger=MetricLogger(quiet=True))
