"""Batched evaluation (``evaluate_many(vmap_eval=True)``) on the CPU.

Against the JAX package's ``_evaluate_many_vmapped`` (3 classes, 64x64x8,
2 nets, fp32): the JAX nets' keys are ``split(base_key, 2)``, and each
net's initial θ, permutations and slot draws are reproduced from its key
(``test_torch_evaluate._jax_draws``) and handed to the port as one
``EvalDraws`` per net; dropout is one fixed keep-mask, as there. The
trained θ of every net must agree within 1e-4 relative norm, and the train
accuracies, top-1/3/5 and per-class accuracies exactly: the tolerances the
sequential path is held to in ``test_torch_evaluate.py``. Mode
'multi-static' runs 3 epochs of 2 steps (a ragged last batch), mode 'none'
2 epochs.

Then, in the port alone: batched against sequential on the same draws (θ
within 1e-5, accuracies within one test clip); the plain versions of the
kernels called once per batched step for all nets (pack, phase max,
scatter, hal_fused) and once per test batch (pack, phase max); and the
nets split into groups under a small ``dm.FOLD_ELEMENTS``, with the same
result (1e-6) and one call per group.
"""

import contextlib
import dataclasses

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
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.distill import dm
from video_distillation_torch.distill import evaluate as teval
from video_distillation_torch.distill.params import from_jax_params
from video_distillation_torch.distill.s2d import S2DConfig
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.ops import hal_fused as hf
from video_distillation_torch.ops import phase_trio as pt
from video_distillation_torch.ops import s2d2_move as sm

from test_torch_evaluate import DATA, IM, MESH_ROWS, NC, F, _jax_draws
from test_torch_mtt import _fixed_dropout, rel_norm

E = 2
MULTI = dict(model="ConvNet3D", epoch_eval_train=2, lr_net=0.01, batch_train=2)
RAW = dict(model="ConvNet3D", epoch_eval_train=1, lr_net=0.01, batch_train=4)


def _jax_vmapped(mode, ecfg_kw, syn=None, labels=None):
    """(JAX results, JAX trained θ (E, P), the port's evaluate_many inputs
    with the JAX draws, one per net)."""
    rng = np.random.default_rng(1)
    mask = rng.random((MESH_ROWS, 1, 1, 1, 128)) < 0.5
    jdata, tdata = jax_synthetic(**DATA), torch_synthetic(**DATA)
    base = jax.random.PRNGKey(3)
    keys = jax.random.split(base, E)
    jcfg = jeval.EvalConfig(mode=mode, **ecfg_kw)
    tcfg = teval.EvalConfig(mode=mode, **ecfg_kw)
    meta = jdata.meta
    jeval._build_train_fn_cached.cache_clear()
    if mode == "multi-static":
        js2d = JaxS2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
        jstate = jax_init(jax.random.PRNGKey(0), js2d)
        n_syn, s2d_key = NC, tuple(sorted(dataclasses.asdict(js2d).items()))
        jargs = (None, None, jdata, jcfg, np.random.default_rng(5), js2d,
                 jstate)
        tstate = {"static": torch.tensor(np.asarray(jstate["static"])),
                  "dynamic": torch.tensor(np.asarray(jstate["dynamic"])),
                  "hals": [from_jax_params(Hallucinator(), p)
                           for p in jstate["hals"]]}
        targs = (None, None, tdata, tcfg, np.random.default_rng(5),
                 S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM)), tstate)
    else:
        js2d, n_syn, s2d_key = None, len(syn), None
        jargs = (jnp.asarray(syn), jnp.asarray(labels), jdata, jcfg,
                 np.random.default_rng(5))
        targs = (torch.from_numpy(syn), torch.from_numpy(labels), tdata,
                 tcfg, np.random.default_rng(5))
    # the run's own train_fn (lru-cached), whose vmapped outputs are kept
    train_fn, _ = jeval._build_train_fn(
        jcfg.model, meta.channel, meta.num_classes, tuple(meta.im_size),
        meta.frames, n_syn, jcfg, s2d_key)
    real_vmap, seen = jax.vmap, {}

    def vmap_spy(fn, *a, **k):
        mapped = real_vmap(fn, *a, **k)
        if fn is not train_fn:
            return mapped

        def keep(*args):
            out = mapped(*args)
            seen["params"] = out[0]
            return out
        return keep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _fixed_dropout(mask))
        mp.setattr(jax, "vmap", vmap_spy)
        results, _, _ = jeval._evaluate_many_vmapped(base, E, *jargs)
    params = seen["params"]
    jeval._build_train_fn_cached.cache_clear()
    theta = np.stack([np.asarray(ravel_pytree(
        jax.tree.map(lambda a, e=e: a[e], params))[0]) for e in range(E)])
    drawn = [_jax_draws(k, n_syn, jcfg, js2d) for k in keys]
    steps, bt = drawn[0][1:]
    km = torch.from_numpy(mask[:bt]).expand(steps, *mask[:bt].shape)
    return results, theta, dict(args=targs, draws=[d[0] for d in drawn],
                                keep_masks=[km] * E)


def _port(inputs, vmap_eval=True):
    return teval.evaluate_many(None, E, *inputs["args"][:5],
                               *inputs["args"][5:], vmap_eval=vmap_eval,
                               draws=inputs["draws"],
                               keep_masks=inputs["keep_masks"])[0]


PLAIN = ((sm, "pack_plain"), (pt, "phase_argmax_plain"),
         (pt, "phase_scatter_plain"), (pt, "phase_select_plain"),
         (sm, "unpack_plain"), (hf, "hal_fused_plain"))


@contextlib.contextmanager
def plain_calls():
    """Counts of the kernels' plain versions' calls (one a launch on the
    card) while the block runs."""
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in PLAIN:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **k):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a, **k)

            mp.setattr(mod, name, spy)
        yield counts


def n_test_batches(inputs):
    """Test batches a pass: 3 repeats of ceil(N_test / 64)."""
    data = inputs["args"][2]
    return 3 * -(-len(data.test) // teval.TEST_BATCH)


def evaluated(mode, kw, *raw):
    """(JAX results, JAX θ, the port's inputs, the port's batched results,
    the plain calls of the port's run)."""
    ref, theta, inputs = _jax_vmapped(mode, kw, *raw)
    with plain_calls() as counts:
        got = _port(inputs)
    return ref, theta, inputs, got, counts


@pytest.fixture(scope="module")
def multi_static():
    return evaluated("multi-static", MULTI)


@pytest.fixture(scope="module")
def raw_set():
    rng = np.random.default_rng(2)
    syn = rng.normal(size=(2 * NC, F, IM, IM, 3)).astype(np.float32)
    labels = np.repeat(np.arange(NC), 2).astype(np.int64)
    return evaluated("none", RAW, syn, labels)


BOTH = pytest.mark.parametrize("which", ["multi_static", "raw_set"])


@BOTH
def test_batched_params_match_jax(request, which):
    _, theta, _, got, _ = request.getfixturevalue(which)
    for e in range(E):
        err = rel_norm(got[e].params.numpy(), theta[e])
        assert err <= 1e-4, (e, err)
    assert rel_norm(theta[0], theta[1]) > 1e-2  # two different nets


@BOTH
def test_batched_accuracies_match_jax(request, which):
    ref, _, _, got, _ = request.getfixturevalue(which)
    for r, g in zip(ref, got):
        assert g.acc_train == pytest.approx(r.acc_train, abs=1e-7)
        assert (g.top1, g.top3, g.top5) == (r.top1, r.top3, r.top5)
        assert g.acc_test == r.acc_test
        np.testing.assert_array_equal(g.acc_per_class, r.acc_per_class)


@BOTH
def test_batched_matches_sequential(request, which):
    """θ within 1e-5; an accuracy may differ by one clip, where two logits
    of a clip are within that rounding of each other (it happens on this
    toy set: 1 of 18 test clips)."""
    _, _, inputs, got, _ = request.getfixturevalue(which)
    seq = _port(inputs, vmap_eval=False)
    clip = 1.0 / (3 * len(inputs["args"][2].test))
    for g, s in zip(got, seq):
        assert rel_norm(g.params.numpy(), s.params.numpy()) <= 1e-5
        for a, b in ((g.top1, s.top1), (g.top3, s.top3), (g.top5, s.top5)):
            assert abs(a - b) <= clip + 1e-12


def test_batched_calls_each_kernel_once_a_step(multi_static):
    _, _, inputs, _, counts = multi_static
    steps = (MULTI["epoch_eval_train"] + 1) * 2  # 3 videos in batches of 2
    tests = n_test_batches(inputs)
    assert counts == {"hal_fused_plain": steps, "pack_plain": steps + tests,
                      "phase_argmax_plain": steps + tests,
                      "phase_scatter_plain": steps}


def test_nets_in_groups_give_the_same_result(raw_set, monkeypatch):
    """A limit under one net's batch puts every net in its own group: one
    call per group a step, and the same trained nets."""
    _, _, inputs, got, _ = raw_set
    monkeypatch.setattr(dm, "FOLD_ELEMENTS", 1)
    with plain_calls() as counts:
        grouped = _port(inputs)
    steps = (RAW["epoch_eval_train"] + 1) * 2  # 6 videos in batches of 4
    assert counts["phase_scatter_plain"] == E * steps
    assert counts["phase_argmax_plain"] == E * (steps + n_test_batches(inputs))
    for g, r in zip(grouped, got):
        assert rel_norm(g.params.numpy(), r.params.numpy()) <= 1e-6
        assert (g.top1, g.top3, g.top5) == (r.top1, r.top3, r.top5)


def test_net_groups():
    per_clip = 16 * 112 * 112 * 16  # ConvNet3D's first stage, 112x112x16
    assert teval.net_groups(5, 64, per_clip) == [slice(0, 5)]
    assert teval.net_groups(6, 64, per_clip) == [slice(0, 5), slice(5, 6)]
    assert teval.net_groups(3, 50, per_clip) == [slice(0, 3)]
    assert teval.net_groups(2, 10 ** 6, per_clip) == [slice(0, 1), slice(1, 2)]


def test_config_defaults_to_batched_evaluation():
    from video_distillation_tpu import config as jconfig
    from video_distillation_torch import config as tconfig
    assert tconfig.DistillConfig().vmap_eval is True
    assert tconfig.DistillConfig().vmap_eval == jconfig.DistillConfig().vmap_eval
