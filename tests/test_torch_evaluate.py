"""The port's synthetic-set evaluation against the JAX package's, on the CPU.

One ``evaluate_synset`` run in each package from the same inputs (3
classes, 64x64x8, fp32):

* initial parameters: the JAX model's ``init`` with the run's ``k_init``,
  handed to the port as the JAX flat vector;
* per-epoch permutations and per-step slot draws: JAX's own
  ``jax.random`` calls, reproduced from the run's key. ``tests/conftest.py``
  gives JAX an 8-device mesh, so JAX pads each training batch to a multiple
  of 8 rows (evaluate.py:226-233): the slot bits are drawn at that padded
  shape and the port receives the first rows;
* dropout: a flax Dropout that applies one fixed numpy keep-mask, which the
  port receives too (as in ``test_torch_mtt.py``);
* test crops: the same numpy ``test_rng``.

Mode 'multi-static' runs 5 epochs in batches of 2 (a ragged last batch),
so the LR drop and the momentum reset both happen. Final parameters must
agree within 1e-4 relative norm (fp32 sums in other orders over 10 SGD
steps); the train accuracy, top-1/3/5 and per-class accuracy exactly.
Mode 'none' is compared the same way over 2 epochs.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.data.synthetic import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import evaluate as jeval
from video_distillation_tpu.distill.s2d import S2DConfig as JaxS2DConfig
from video_distillation_tpu.distill.s2d import init_s2d_state as jax_init
from video_distillation_tpu.models import registry as jreg
from video_distillation_tpu.ops import metrics as jmetrics
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.distill.s2d import S2DConfig
from video_distillation_torch.models import registry as treg
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.ops import metrics as tmetrics

from test_torch_mtt import _fixed_dropout, rel_norm  # tests/ is on sys.path
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM = 3, 8, 64
DATA = dict(num_classes=NC, clips_per_class=2, test_per_class=2, frames=F,
            im_size=(IM, IM), seed=0, name="synthetic_eval_parity")
MESH_ROWS = 8  # tests/conftest.py's virtual devices


def _jax_draws(key, n_syn, cfg, s2d_cfg=None):
    """The initial θ, permutations and slot draws of evaluate.py:198-293,
    from the run's own key."""
    k_init, k_perm, _, k_slots = jax.random.split(key, 4)
    model_def = jreg.create_model(cfg.model, 3, NC, (IM, IM), F)
    sample = jeval._video_crop(jnp.zeros((1, F, IM, IM, 3)), cfg.model)
    params = model_def.init({"params": k_init, "dropout": k_init}, sample,
                            train=False)["params"]
    epochs = cfg.epoch_eval_train + 1
    perms = jax.vmap(lambda k: jax.random.permutation(k, n_syn))(
        jax.random.split(k_perm, epochs))
    bt = min(cfg.batch_train, n_syn)
    steps = epochs * -(-n_syn // bt)
    slots = None
    if s2d_cfg is not None:
        slots = []
        for s in range(steps):
            k1, k2, k3 = jax.random.split(jax.random.fold_in(k_slots, s), 3)
            padded = bt + (-bt) % MESH_ROWS
            slots.append([np.array(jax.random.randint(k, (padded,), 0, hi))[:bt]
                          for k, hi in ((k1, s2d_cfg.spc), (k2, s2d_cfg.dpc),
                                        (k3, max(1, s2d_cfg.n_hal)))])
    return (teval.EvalDraws(np.asarray(ravel_pytree(params)[0]),
                            np.asarray(perms), slots), steps, bt)


def _run_both(mode, ecfg_kw, syn=None, labels=None):
    """(JAX EvalResult, port EvalResult) of one run from the same inputs."""
    rng = np.random.default_rng(1)
    mask = rng.random((MESH_ROWS, 1, 1, 1, 128)) < 0.5
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    key = jax.random.PRNGKey(3)
    jcfg = jeval.EvalConfig(mode=mode, **ecfg_kw)
    tcfg = teval.EvalConfig(mode=mode, **ecfg_kw)
    jeval._build_train_fn_cached.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _fixed_dropout(mask))
        if mode == "multi-static":
            js2d = JaxS2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
            jstate = jax_init(jax.random.PRNGKey(0), js2d)
            ref = jeval.evaluate_synset(key, None, None, jdata, jcfg,
                                        np.random.default_rng(5), js2d, jstate)
            tstate = {"static": torch.tensor(np.asarray(jstate["static"])),
                      "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
                      "hals": [from_jax_params(Hallucinator(), p)
                               for p in jstate["hals"]]}
            ts2d = S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
            draws, steps, bt = _jax_draws(key, NC, jcfg, js2d)
            args = (None, None, tdata, tcfg, np.random.default_rng(5), ts2d,
                    tstate)
        else:
            ref = jeval.evaluate_synset(key, jnp.asarray(syn),
                                        jnp.asarray(labels), jdata, jcfg,
                                        np.random.default_rng(5))
            draws, steps, bt = _jax_draws(key, len(syn), jcfg)
            args = (torch.from_numpy(syn), torch.from_numpy(labels), tdata,
                    tcfg, np.random.default_rng(5))
    jeval._build_train_fn_cached.cache_clear()
    got = teval.evaluate_synset(None, *args, draws=draws,
                                keep_masks=torch.from_numpy(mask[:bt]).expand(
                                    steps, *mask[:bt].shape))
    return ref, got


@pytest.fixture(scope="module")
def multi_static():
    # 3 synthetic videos in batches of 2: 2 steps an epoch; epochs 0..4,
    # LR x0.1 in epoch 4 (> 4//2+1 = 3), momentum reset on its first step
    return _run_both("multi-static", dict(model="ConvNet3D",
                                          epoch_eval_train=4, lr_net=0.01,
                                          batch_train=2))


@pytest.fixture(scope="module")
def raw_set():
    rng = np.random.default_rng(2)
    syn = rng.normal(size=(2 * NC, F, IM, IM, 3)).astype(np.float32)
    labels = np.repeat(np.arange(NC), 2).astype(np.int64)
    return _run_both("none", dict(model="ConvNet3D", epoch_eval_train=1,
                                  lr_net=0.01, batch_train=4), syn, labels)


@pytest.mark.parametrize("which", ["multi_static", "raw_set"])
def test_trained_params_match_jax(request, which):
    ref, got = request.getfixturevalue(which)
    err = rel_norm(got.params.numpy(), ravel_pytree(ref.params)[0])
    assert err <= 1e-4, err


@pytest.mark.parametrize("which", ["multi_static", "raw_set"])
def test_accuracies_match_jax(request, which):
    ref, got = request.getfixturevalue(which)
    assert got.acc_train == ref.acc_train
    assert (got.top1, got.top3, got.top5) == (ref.top1, ref.top3, ref.top5)
    assert got.acc_test == ref.acc_test
    np.testing.assert_array_equal(got.acc_per_class, ref.acc_per_class)
    assert 0.0 <= got.top1 <= 1.0


def test_training_moved_the_net(multi_static):
    _, got = multi_static
    init = _jax_draws(jax.random.PRNGKey(3), NC, jeval.EvalConfig(
        epoch_eval_train=4, batch_train=2))[0].theta
    assert rel_norm(got.params.numpy(), init) > 1e-4


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(20, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 20)
    w = (rng.random(20) < 0.7).astype(np.float32)
    ref = jmetrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels))
    got = tmetrics.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in ref.items()}
    weighted = tmetrics.topk_correct(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     weights=torch.from_numpy(w))
    hits1 = logits.argmax(-1) == labels
    assert float(weighted[1]) == float((hits1 * w).sum())
    rc, rn = jmetrics.per_class_correct(jnp.asarray(logits), jnp.asarray(labels),
                                        7, jnp.asarray(w))
    gc, gn = tmetrics.per_class_correct(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 7,
                                        torch.from_numpy(w))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))


@pytest.mark.parametrize("mode", ["M", "B", "W", "D", "A", "P", "N", "S",
                                  "SS", "top5"])
def test_eval_pool_matches_jax(mode):
    for model in ("ConvNet3D", "ConvNetBN"):
        assert treg.get_eval_pool(mode, model) == jreg.get_eval_pool(mode, model)


def test_test_batches_match_jax():
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    cfg = teval.EvalConfig(test_repeats=2)
    ref = jeval.sample_test_batches(jdata, jeval.EvalConfig(test_repeats=2),
                                    np.random.default_rng(4))
    got = teval.sample_test_batches(tdata, cfg, np.random.default_rng(4), "cpu")
    for (rc, rl, rw), (gc, gl, gw) in zip(ref, got):
        assert gc.dtype == torch.uint8
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
