"""The port's FRePo (``distill/frepo.py``, ``drivers/distill_frepo.py``) and
FRePo's evaluation protocol against the JAX package, on the CPU in fp32.

Shapes are ``tests/test_frepo.py``'s: 3 classes, 64x64x8, ConvNet3D,
``num_nn_state=2``, ``max_online_updates=5``, ``batch_real=8``. Every
input comes from numpy seeds; the JAX trainer's state, its pool nets and
their Adam moments are carried across with ``params.frepo_carry_from_jax``;
the JAX trainer's own jitted ``proto_step`` and ``pool_train_step`` are
taken from the closure of its ``step``; the hallucinator draws are
reproduced from the step's key; dropout is a flax Dropout that applies one
fixed numpy keep-mask, which the port receives too. Tolerances:

* ``frepo_labels``: bit-equal;
* ``nfr`` and its gradients: each within 3x of the JAX fp32 result's
  distance from fp64 (or 1e-6), relative norm (on its inputs cond(K_pp +
  reg) is 1.3e2, printed by ``test_nfr_matches_jax``; the JAX result is
  8.5e-5 from the port's there);
* both schedules and Adam at the counts 0, 1, 499, 500 and 10000: 1e-6
  relative (fp32 cosines of two libraries);
* one proto step: loss within 5e-5 relative, the gradients (Adam's first
  moments) within 1e-4 relative norm, the updated hallucinators within
  1e-5 and the updated dynamic memory (or raw prototypes) within 3e-3
  relative norm; the labels untouched. The KRR loss is sensitive in fp32
  (cond(K_pp + reg) is 80 here): the JAX package's own jitted step is
  1.8e-5 from the fp64 value of its loss, and its eager ``nfr`` of the same
  features 9e-6, so the port (2e-6) cannot be held closer to it than that;
  the gradients measure 1.3-4.6e-5 apart. Adam's first step moves each
  element by ``lr g / (|g| + 1e-8)``: the many elements of the dynamic
  memory whose gradient is within a few 1e-8 of zero turn that gradient
  difference into 4-10e-4 of the update (measured);
* three pool steps on one net, the last of which crosses
  ``max_online_updates``: θ and Adam's first moment within 1e-5 relative
  norm, the counters equal, and after the reset the JAX re-initialised net
  (handed in) with zero moments;
* ``n_hal=2`` and the raw mode (``s2d=False``): a proto step as above;
* ``krr_evaluate``: the same accuracy;
* FRePo's evaluation protocol (AdamW, MSE on soft labels, no batch
  standardisation, EMA 0.995) over 2 epochs, and each of its three fields
  alone over 1 epoch, against JAX ``evaluate_synset``: the trained θ within
  1e-5 relative norm, every accuracy equal;
* the driver: 2 iterations, then a restart, equal to 4 straight iterations
  in state, optimizer, pool and host RNG (bit-equal: one device, one
  order);
* each kernel wrapper is called on the CPU as often as its kernel launches
  on the card: per outer step, pack and phase_argmax once per real chunk
  and twice more (the prototypes' forward, the pool step's), phase_scatter
  twice, unpack once (the backward into the prototypes), select never;
  ``hal_fwd``, ``hal_dgrad`` and ``hal_wgrad`` once (the proto step's
  compose) and ``hal_fused`` once (``compose_eval``).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from video_distillation_tpu.data import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.distill import frepo as jfrepo
from video_distillation_tpu.distill.evaluate import \
    _build_train_fn_cached as _jax_eval_cache
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.distill import frepo
from video_distillation_torch.distill.params import (frepo_carry_from_jax,
                                                     from_jax_params,
                                                     layout_for)
from video_distillation_torch.drivers import distill_frepo
from video_distillation_torch.models.hallucinator import Hallucinator
from video_distillation_torch.models.registry import create_model

from test_torch_evaluate import _run_both  # tests/ is on sys.path
from test_torch_mtt import _fixed_dropout, rel_norm

NC, F, IM = 3, 8, 64
DATA = dict(num_classes=NC, clips_per_class=6, test_per_class=2, frames=F,
            im_size=(IM, IM), name="frepo-parity")
CFG = dict(num_classes=NC, ppc=1, dpc=1, frames=F, im_size=(IM, IM),
           num_nn_state=2, max_online_updates=5, Iteration=10, batch_real=8,
           lr_d=1.0, lr_h=1e-3, lr_net=1e-3)
TOL = 1e-5
LOSS_TOL = 5e-5
GRAD_TOL = 1e-4
BIG_TOL = 3e-3


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pool_element(el):
    """A JAX pool element as ``frepo_carry_from_jax`` reads it."""
    adam = el["opt"][0]
    return {"params": _np(el["params"]), "mu": _np(adam.mu),
            "nu": _np(adam.nu), "count": int(adam.count), "step": el["step"]}


def _masked(tree):
    """The leaves of one optax ``multi_transform`` group's tree, without
    the other group's ``MaskedNode``s."""
    return {k: v for k, v in tree.items()
            if jax.tree_util.tree_leaves(v)}


def _opt_moments(opt_state):
    """(mu, nu) of the synthetic state from the JAX multi_transform state."""
    mu, nu = {}, {}
    for group in opt_state.inner_states.values():
        adam = group.inner_state[0]
        mu.update(_np(_masked(adam.mu)))
        nu.update(_np(_masked(adam.nu)))
    return mu, nu


@pytest.fixture(scope="module")
def stores():
    return jax_synthetic(**DATA), torch_synthetic(**DATA)


@pytest.fixture(scope="module")
def static():
    return np.random.default_rng(0).normal(size=(NC, IM, IM, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def mask():
    return np.random.default_rng(1).random((NC, 1, 1, 1, 128)) < 0.5


def _jax_run(stores, static, mask, pool_steps=0, **over):
    """One JAX proto step from the trainer's initial carry (key 5, the real
    batch and pool index from ``default_rng(7)``), then ``pool_steps``
    steps of pool net 1 on the composed prototypes."""
    jdata, _ = stores
    cfg = jfrepo.FRePoConfig(**{**CFG, **over})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _fixed_dropout(mask))
        (state0, opt0), step, pool, compose_eval = jfrepo.make_frepo_trainer(
            jdata.train, "ConvNet3D", cfg, jax.random.PRNGKey(0),
            static if cfg.s2d else None)
        fns = _closure(step)
        pool0 = [_pool_element(el) for el in pool.elements]
        np_rng = np.random.default_rng(7)
        real_idx = np_rng.choice(len(jdata.train), size=cfg.batch_real,
                                 replace=False).astype(np.int32)
        idx = pool.sample_idx(np_rng)
        key = jax.random.PRNGKey(5)
        state1, opt1, loss, _, _ = fns["proto_step"](
            key, state0, opt0, pool.elements[idx]["params"],
            fns["pad_and_shard_plan"](real_idx))
        out = dict(cfg=cfg, state0=_np(state0), pool0=pool0,
                   real_idx=real_idx, idx=idx, state1=_np(state1),
                   moments=_opt_moments(opt1), loss=float(loss), key=key,
                   model_def=pool.model_def,
                   tx=_closure(fns["proto_step"].__wrapped__)["tx"])
        if pool_steps:
            x = compose_eval(jax.random.PRNGKey(6), state1)
            out["x"] = np.asarray(x)
            hist = []
            for _ in range(pool_steps):
                pool.train_step(1, x, state1["y_syn"],
                                np.random.default_rng(8),
                                fns["pool_train_step"])
                hist.append(_pool_element(pool.elements[1]))
            out["pool_hist"] = hist
    return out


@pytest.fixture(scope="module")
def jax_s2d(stores, static, mask):
    return _jax_run(stores, static, mask, pool_steps=3)


def _port(stores, static, ref, **over):
    """The port's trainer, carried to the JAX run's initial state."""
    _, tdata = stores
    cfg = frepo.FRePoConfig(**{**CFG, **over})
    tr = frepo.FRePoTrainer(tdata.train, "ConvNet3D", cfg, None,
                            static if cfg.s2d else None, "cpu")
    tr.load_state_dict(frepo_carry_from_jax(tr.model, ref["state0"],
                                            ref["pool0"]))
    return tr


def _proto_step(tr, ref, hal_choice=None):
    return tr.proto_step(tr.pool.params(ref["idx"]),
                         torch.as_tensor(ref["real_idx"]).long(), hal_choice)


def _hal(tree):
    return from_jax_params(Hallucinator(), tree)


def _check_proto_step(tr, ref, loss):
    mu, _ = ref["moments"]
    st0, st1 = ref["state0"], ref["state1"]
    big = "dynamic" if tr.cfg.s2d else "x_proto"
    err = {"loss": abs(float(loss) / ref["loss"] - 1),
           "grad_" + big: rel_norm(tr.opt["m"][big], mu[big]),
           big: rel_norm(tr.state[big], st1[big])}
    assert not np.array_equal(tr.state[big].numpy(), st0[big])
    for i, (got_m, got, want_m, want) in enumerate(zip(
            tr.opt["m"].get("hals", []), tr.state.get("hals", []),
            mu.get("hals", []), st1.get("hals", []))):
        for k in ("weight", "bias"):
            err[f"grad_hal{i}_{k}"] = rel_norm(got_m[k], _hal(want_m)[k])
            err[f"hal{i}_{k}"] = rel_norm(got[k], _hal(want)[k])
    for k, v in err.items():
        tol = (LOSS_TOL if k == "loss" else GRAD_TOL if k.startswith("grad")
               else BIG_TOL if k == big else TOL)
        assert v <= tol, (k, v, err)
    # the labels are not learned: untouched, as in the JAX step
    np.testing.assert_array_equal(tr.state["y_syn"].numpy(), st1["y_syn"])
    assert tr.opt["count"] == 1


def test_frepo_labels_bit_equal():
    labels = np.random.default_rng(0).integers(0, 7, 20)
    for scale in (None, float(np.sqrt(0.7))):
        np.testing.assert_array_equal(frepo.frepo_labels(labels, 7, scale),
                                      jfrepo.frepo_labels(labels, 7, scale))


def test_nfr_matches_jax():
    """Non-negative features with a common part, as after a ReLU: cond(K_pp
    + reg) is 1.3e2 here (printed below; the prototypes' ConvNet3D features
    in ``test_proto_step_matches_jax`` give 80). The prediction subtracts
    near-equal kernel rows, so fp32 strays from fp64 by far more than
    1e-5: each of the port's fp32 results is held within 3x of the JAX
    fp32 result's distance from fp64 (or 1e-6)."""
    rng = np.random.default_rng(0)
    ft = (np.abs(rng.normal(size=(8, 256))) + 3).astype(np.float32)
    fp = (np.abs(rng.normal(size=(NC, 256))) + 3).astype(np.float32)
    y = jfrepo.frepo_labels(np.arange(NC), NC, np.sqrt(NC / 10))
    r = rng.normal(size=(8, NC)).astype(np.float32)
    k = fp.astype(np.float64) @ fp.T.astype(np.float64)
    k_reg = k + 1e-6 * np.trace(k) / NC * np.eye(NC)
    print("cond(K_pp + reg):", np.linalg.cond(k_reg))

    def jloss(a, b):
        return jnp.sum(jfrepo.nfr(a, b, jnp.asarray(y)) * r)

    ref = jfrepo.nfr(jnp.asarray(ft), jnp.asarray(fp), jnp.asarray(y))
    gref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ft), jnp.asarray(fp))

    def port(dt):
        a = torch.from_numpy(ft).to(dt).requires_grad_(True)
        b = torch.from_numpy(fp).to(dt).requires_grad_(True)
        out = frepo.nfr(a, b, torch.from_numpy(y).to(dt))
        ga, gb = torch.autograd.grad((out * torch.from_numpy(r).to(dt)).sum(),
                                     (a, b))
        return out.detach(), ga, gb

    got, f64 = port(torch.float32), port(torch.float64)
    assert got[0].dtype == torch.float32 and f64[0].dtype == torch.float64
    # the fp64 prediction is the formula's, by numpy
    np.testing.assert_allclose(f64[0].numpy(), ft.astype(np.float64) @ fp.T
                               @ np.linalg.solve(k_reg, y), rtol=1e-10)
    for name, g, j, t in zip(("pred", "grad_target", "grad_proto"), got,
                             (ref, *gref), f64):
        d_port, d_jax = rel_norm(g, t), rel_norm(j, t)
        print(name, "from fp64: port", d_port, "JAX", d_jax)
        assert d_port <= max(3 * d_jax, 1e-6), (name, d_port, d_jax)


COUNTS = (0, 1, 499, 500, 10000)


@pytest.mark.parametrize("count", COUNTS)
def test_pool_schedule_matches_jax(count):
    ref = float(jfrepo._pool_schedule(3e-4, 100)(count))
    got = float(frepo.pool_lr(3e-4, 100, count))
    assert abs(got / ref - 1) <= 1e-6


@pytest.mark.parametrize("count", COUNTS)
def test_proto_schedule_and_adam_match_jax(jax_s2d, count):
    """The JAX synthetic optimizer (its ``tx``, from the proto step's
    closure) at optax count ``count`` against the port's Adam at
    ``proto_lr``, each group at its rate, on one gradient from zero
    moments."""
    cfg = jax_s2d["cfg"]
    state = jax.tree.map(jnp.asarray, jax_s2d["state0"])
    rng = np.random.default_rng(count)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 1e-3), state)
    tx = jax_s2d["tx"]
    opt = jax.tree.map(lambda x: jnp.full_like(x, count)
                       if x.dtype == jnp.int32 else x, tx.init(state))
    upd, _ = tx.update(grads, opt, state)
    for name, lr in (("dynamic", cfg.lr_d), ("y_syn", cfg.lr_h)):
        g = torch.from_numpy(np.asarray(grads[name]))
        z = torch.zeros_like(g)
        p, _, _ = frepo.adam_update(z, g, z, z, count, frepo.proto_lr(
            lr, cfg.lr_h, cfg.Iteration, count))
        assert rel_norm(p, upd[name]) <= 1e-6, name


def test_proto_step_matches_jax(stores, static, jax_s2d):
    tr = _port(stores, static, jax_s2d)
    loss, _, _, _ = _proto_step(tr, jax_s2d)
    _check_proto_step(tr, jax_s2d, loss)


def test_pool_steps_and_reset_match_jax(stores, static, mask, jax_s2d):
    """Net 1 starts at step 2 (staggered by 5 // 2): its third step reaches
    ``max_online_updates`` and resets it to the JAX re-initialised net."""
    ref = jax_s2d
    tr = _port(stores, static, ref)
    layout = layout_for(tr.model)
    reset = ref["pool_hist"][-1]
    tr.pool.init_params = lambda generator: layout.flatten(
        layout.from_jax(reset["params"]))
    x = torch.from_numpy(ref["x"])
    y = torch.from_numpy(ref["state1"]["y_syn"])
    assert tr.pool.elements[1]["step"] == 2
    for k, want in enumerate(ref["pool_hist"]):
        tr.pool.train_step(1, x, y, np.random.default_rng(8), None,
                           torch.from_numpy(mask))
        el = tr.pool.elements[1]
        assert (el["count"], el["step"]) == (want["count"], want["step"])
        theta = layout.flatten(layout.from_jax(want["params"]))
        if k < 2:
            assert rel_norm(el["params"], theta) <= TOL
            assert rel_norm(el["m"], layout.flatten(
                layout.from_jax(want["mu"]))) <= TOL
            assert rel_norm(el["params"], layout.flatten(layout.from_jax(
                ref["pool0"][1]["params"]))) > TOL
        else:
            assert (el["count"], el["step"]) == (0, 0)
            assert torch.equal(el["params"], theta)
            assert not el["m"].any() and not el["v"].any()
    # net 0 is untouched
    assert torch.equal(tr.pool.elements[0]["params"], layout.flatten(
        layout.from_jax(ref["pool0"][0]["params"])))


def test_two_hallucinators_match_jax(stores, static, mask):
    ref = _jax_run(stores, static, mask, n_hal=2)
    tr = _port(stores, static, ref, n_hal=2)
    kh = jax.random.split(ref["key"], 1)[0]
    hal = np.asarray(jax.random.randint(kh, (NC,), 0, 2))
    assert len(set(hal.tolist())) == 2  # both hallucinators take part
    loss, _, _, _ = _proto_step(tr, ref, torch.from_numpy(hal))
    _check_proto_step(tr, ref, loss)


def test_raw_mode_matches_jax(stores, static, mask):
    ref = _jax_run(stores, static, mask, s2d=False)
    tr = frepo.FRePoTrainer(stores[1].train, "ConvNet3D",
                            frepo.FRePoConfig(**CFG, s2d=False), None, None,
                            "cpu")
    # the initial prototypes: real clips drawn by default_rng(0)
    np.testing.assert_allclose(tr.state["x_proto"].numpy(),
                               ref["state0"]["x_proto"], rtol=0, atol=1e-6)
    tr = _port(stores, static, ref, s2d=False)
    loss, _, _, _ = _proto_step(tr, ref)
    _check_proto_step(tr, ref, loss)


def test_ppc_and_dpc_must_be_equal(stores):
    with pytest.raises(ValueError, match="ppc == dpc"):
        frepo.FRePoTrainer(stores[1].train, "ConvNet3D",
                           frepo.FRePoConfig(**{**CFG, "ppc": 2}), None, None,
                           "cpu")


def test_krr_evaluate_matches_jax(stores, jax_s2d):
    jdata, tdata = stores
    ref = jax_s2d
    el = ref["pool0"][0]["params"]
    clips = tdata.test.sample_clips(np.random.default_rng(3))
    meta = tdata.meta
    want = jfrepo.krr_evaluate(ref["model_def"], jax.tree.map(jnp.asarray, el),
                               jnp.asarray(ref["x"]),
                               jnp.asarray(ref["state1"]["y_syn"]), clips,
                               jdata.test.labels, meta.mean, meta.std)
    tr_model = create_model("ConvNet3D", 3, NC, (IM, IM), F)
    got = frepo.krr_evaluate(tr_model, from_jax_params(tr_model, el),
                             torch.from_numpy(ref["x"]),
                             torch.from_numpy(ref["state1"]["y_syn"]), clips,
                             tdata.test.labels, meta.mean, meta.std)
    assert got == want
    assert 0.0 <= got <= 1.0


def _soft_set():
    rng = np.random.default_rng(2)
    syn = rng.normal(size=(2 * NC, F, IM, IM, 3)).astype(np.float32)
    labels = np.repeat(np.arange(NC), 2)
    return syn, labels, frepo.frepo_labels(labels, NC, np.sqrt(NC / 10))


FREPO_PROTOCOL = dict(optimizer="adamw", loss="mse", standardize=False,
                      ema_decay=0.995)


@pytest.mark.parametrize("field", [None, "optimizer", "loss", "ema_decay"],
                         ids=["full", "adamw", "mse", "ema"])
def test_frepo_protocol_matches_jax(field):
    """The full protocol over 2 epochs, or one of its fields alone over 1
    epoch (the JAX package takes each alone: SGD unless 'adamw', CE unless
    'mse'), against JAX ``evaluate_synset`` with θ, permutations and
    keep-masks handed in."""
    syn, hard, soft = _soft_set()
    if field is None:
        kw = dict(FREPO_PROTOCOL, epoch_eval_train=1)
    else:
        kw = {field: FREPO_PROTOCOL[field], "epoch_eval_train": 0}
    labels = soft if kw.get("loss") == "mse" else hard
    ref, got = _run_both("none", dict(model="ConvNet3D", lr_net=3e-4,
                                      batch_train=4, **kw), syn, labels)
    _jax_eval_cache.cache_clear()
    assert rel_norm(got.params.numpy(), ravel_pytree(ref.params)[0]) <= TOL
    assert got.acc_train == ref.acc_train
    assert (got.top1, got.top3, got.top5) == (ref.top1, ref.top3, ref.top5)
    np.testing.assert_array_equal(got.acc_per_class, ref.acc_per_class)


class _Stop(Exception):
    pass


def _driver(tmp, stop_after=None):
    """4 iterations at the test size, checkpointing every 2; with
    ``stop_after``, the run dies at the end of that iteration."""
    def hook(it, metrics):
        assert np.isfinite(metrics["loss"])
        if it == stop_after:
            raise _Stop

    return distill_frepo.main(
        ["--device", "cpu", "--dataset", "synthetic_c3_n4_t1_f8_im64",
         "--frames", str(F), "--num_nn_state", "2", "--max_online_updates",
         "3", "--lr_d", "1.0", "--Iteration", "4", "--eval_it", "100",
         "--ckpt_it", "2", "--save_path", str(tmp)],
        logger=distill_frepo.MetricLogger(quiet=True), step_hook=hook)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_driver_resume_equals_a_straight_run(tmp_path):
    """A run that dies after its checkpoint at iteration 2 and is restarted
    ends as 4 straight iterations do: the same state, optimizer, pool (which
    resets a net on the way) and host RNG. The CPU's convolutions run on
    one thread here, so two runs are bit-equal."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(_Stop):
            _driver(tmp_path / "a", stop_after=2)
        resumed = _driver(tmp_path / "a")
        straight = _driver(tmp_path / "b")
    finally:
        torch.set_num_threads(threads)
    a, b = (r["trainer"].state_dict() for r in (resumed, straight))
    for x, y in zip(_flat(a), _flat(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    # net 0 was reset by the last iteration's pool step
    assert [(el["step"], el["count"]) for el in a["pool"]] == [(0, 0), (2, 2)]
    assert resumed["np_rng"].bit_generator.state == \
        straight["np_rng"].bit_generator.state


def test_driver_defaults_to_the_card():
    """Without --device the driver runs on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill_frepo.main(["--dataset", "synthetic_c3_n4_t1_f8_im64"])


def _count_calls(monkeypatch):
    """Calls of each first-stage wrapper's plain version and of each
    hallucinator kernel's wrapper: what runs on the CPU, once per kernel
    launch on the card."""
    from video_distillation_torch.distill import s2d
    from video_distillation_torch.ops import hal_conv, phase_trio, s2d2_move
    counts = {}
    targets = [(s2d2_move, "pack_plain", "pack"),
               (s2d2_move, "unpack_plain", "unpack"),
               (phase_trio, "phase_argmax_plain", "phase_argmax"),
               (phase_trio, "phase_select_plain", "phase_select"),
               (phase_trio, "phase_scatter_plain", "phase_scatter"),
               (hal_conv, "hal_fwd", "hal_fwd"),
               (hal_conv, "hal_dgrad", "hal_dgrad"),
               (hal_conv, "hal_wgrad", "hal_wgrad"),
               (s2d, "hal_fused", "hal_fused")]
    for mod, attr, key in targets:
        counts[key] = 0
        fn = getattr(mod, attr)

        def counted(*args, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, attr, counted)
    return counts


def test_kernel_calls_per_outer_step(stores, monkeypatch):
    monkeypatch.setattr(frepo, "REAL_CHUNK", 5)  # 8 real clips: 2 chunks
    tr = frepo.FRePoTrainer(stores[1].train, "ConvNet3D",
                            frepo.FRePoConfig(**CFG),
                            torch.Generator().manual_seed(0), None, "cpu")
    counts = _count_calls(monkeypatch)
    tr.step(torch.Generator().manual_seed(1), np.random.default_rng(0))
    assert counts == {"pack": 4, "phase_argmax": 4, "phase_scatter": 2,
                      "unpack": 1, "phase_select": 0, "hal_fwd": 1,
                      "hal_dgrad": 1, "hal_wgrad": 1, "hal_fused": 1}
