"""Ranks of a gloo process group on the CPU, for the data-parallel tests.

``Ranks(n, checks)`` starts n processes (one torch thread each), which
build their group from a file in a temporary directory and run each check
``(name, function, kwargs)`` in turn, ``function`` being one of this
module's; ``results()`` returns each rank's ``{name: result}``. The ranks
work while the caller does (the JAX package's compiles).
``run_local(checks)`` runs checks in the calling process without a group
(world size 1).
This module imports torch and the port only, never JAX: the JAX package's
draws, nets and states come in as numpy arrays.

The shapes are the port tests' (3 classes, 64x64x8, ConvNet3D, two inner
steps).
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback

import numpy as np
import torch

NC, F, IM, STEPS = 3, 8, 64, 2
LRS = dict(lr_static=100.0, lr_dynamic=0.01, lr_hal=0.01, lr_lr=1e-5)
DM_LRS = dict(lr_static=100.0, lr_dynamic=0.01, lr_hal=0.01)
# "synthetic" names stay out of the registries' comparison
# (tests/test_torch_data.py): only the ranks make this set with the port
STORE = dict(num_classes=NC, clips_per_class=6, test_per_class=2, frames=F,
             im_size=(IM, IM), name="synthetic-dist-parity")


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def _torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch(v) for v in tree]
    return tree


def _rank_main(rank, n, init_file, checks, inbox, results):
    torch.set_num_threads(1)
    import torch.distributed as tdist

    if init_file:
        tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                                 rank=rank, world_size=n)
    try:
        while checks is not None:
            results.put((rank, run_local(checks), None))
            checks = inbox.get()
    except BaseException:  # the parent re-raises it with the traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        if init_file:
            tdist.destroy_process_group()


class Ranks:
    """``n`` spawned processes that run checks: the ranks of a gloo group,
    or (``group=False``, n=1) one process without a group, whose results
    are world size 1's. ``start`` returns at once; ``results()`` waits for
    each rank's results of the checks given last; ``send(checks)`` gives
    them more."""

    def __init__(self, n: int, checks, group: bool = True,
                 timeout: float = 600.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        self._tmp = tempfile.TemporaryDirectory()
        init_file = os.path.join(self._tmp.name, "group") if group else ""
        self._results = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, init_file, checks,
                                         self._inboxes[r], self._results),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()

    def results(self):
        got = {}
        for _ in range(self.n):
            try:
                rank, out, err = self._results.get(timeout=self.timeout)
            except queue.Empty:
                self.close()
                raise AssertionError(f"no result within {self.timeout} s")
            if err:
                self.close()
                raise AssertionError(f"rank {rank}:\n{err}")
            got[rank] = out
        return [got[r] for r in range(self.n)]

    def send(self, checks):
        for box in self._inboxes:
            box.put(checks)

    def close(self):
        self.send(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        self._tmp.cleanup()


def run_local(checks):
    from video_distillation_torch.parallel import dist

    out = {}
    for name, fn, kwargs in checks:
        dist.reset_stats()
        res = globals()[fn](**kwargs)
        res["collectives"] = dict(dist.STATS)
        out[name] = res
    return out


def assert_close(got, ref, tol, path=""):
    """Every array and number of ``got`` within ``tol`` of ``ref``:
    relative norm for arrays, relative for numbers."""
    if isinstance(ref, dict):
        for k in ref:
            if k not in ("collectives", "store_rows"):
                assert_close(got[k], ref[k], tol, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_close(a, b, tol, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert got.shape == ref.shape, path
        err = _rel_norm(got, ref) if np.any(ref) else float(np.abs(got).max())
        assert err <= tol, (path, err)
    elif isinstance(ref, float):
        assert abs(got - ref) <= tol * max(abs(ref), 1e-30), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def _rel_norm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


# -- the checks ---------------------------------------------------------


def double_count_toy(world_sum: bool = True, naive: bool = False):
    """A 3-step inner SGD unroll on a linear model, differentiated to second
    order into ``lr`` and θ₀, fp64, each rank taking its half of an
    8-sample batch. ``naive``: the full outer loss on every rank through
    ``torch.distributed.nn.functional.all_reduce`` (whose backward is a SUM
    all-reduce), the trap the port's ``share`` avoids."""
    from video_distillation_torch.parallel import dist

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 5, generator=gen, dtype=torch.float64)
    y = torch.randn(8, generator=gen, dtype=torch.float64)
    target = torch.randn(5, generator=gen, dtype=torch.float64)
    theta0 = torch.randn(5, generator=gen, dtype=torch.float64,
                         requires_grad=True)
    lr = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    xs, ys = dist.split_columns(x, 0), dist.split_columns(y)
    theta = theta0
    for _ in range(3):
        inner = (((xs @ theta) - ys) ** 2).sum() / 8
        (g,) = torch.autograd.grad(inner, theta, create_graph=True)
        if naive:
            import torch.distributed.nn.functional as dnn
            g = dnn.all_reduce(g)
        else:
            g = dist.reduced(g)
        theta = theta - lr * (g ** 2 + g)
    loss = ((theta - target) ** 2).sum()
    grads = torch.autograd.grad(loss if naive else dist.share(loss),
                                (theta0, lr))
    if world_sum and not naive:
        dist.all_reduce_tensors_(list(grads))
    return {"loss": float(loss), "theta0": _np(grads[0]),
            "lr": float(grads[1])}


def _s2d_inputs(seed):
    from video_distillation_torch.distill.mtt import flat_param_template
    from video_distillation_torch.distill.s2d import S2DConfig, init_s2d_state

    gen = torch.Generator().manual_seed(seed)
    state = init_s2d_state(gen, S2DConfig(num_classes=NC, frames=F,
                                          im_size=(IM, IM)))
    _, t0 = flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    _, t1 = flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    return state, t0, t1


def s2d_mtt(plan, dtype="float64", mode="full", seed=0, inputs=None,
            draws=None, keep_masks=None, gen_seed=1):
    """One S2D-MTT outer step (``S2DMTTStep``): the grand loss, the outer
    gradients and the updated dynamic memory."""
    from video_distillation_torch.distill import mtt
    from video_distillation_torch.distill.s2d import (S2DConfig,
                                                      init_s2d_momentum)

    cdt = getattr(torch, dtype)
    if inputs is None:
        state, t0, t1 = _s2d_inputs(seed)
    else:
        state, t0, t1 = (_torch(inputs[k]) for k in ("state", "t0", "t1"))
    state = {"static": state["static"].to(cdt),
             "dynamic": state["dynamic"].to(cdt),
             "hals": [{k: v.to(cdt) for k, v in h.items()}
                      for h in state["hals"]]}
    step = mtt.S2DMTTStep(
        "ConvNet3D", 3, NC, (IM, IM), F, STEPS,
        S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM)),
        mtt.S2DHyper(**LRS, train_static=False, train_lr=True), dtype, "cpu",
        second_order=mode)
    out = step(torch.Generator().manual_seed(gen_seed), state,
               torch.tensor(0.01), init_s2d_momentum(state),
               torch.zeros((), dtype=cdt), t0.to(cdt), t1.to(cdt),
               torch.as_tensor(plan).long(), draws=draws,
               keep_masks=None if keep_masks is None
               else torch.from_numpy(keep_masks))
    new_state, _, _, _, loss, _, pdist, grads = out
    return {"loss": float(loss), "pdist": float(pdist),
            "grad_dynamic": _np(grads["dynamic"]),
            "grad_hal_weight": _np(grads["hals"][0]["weight"]),
            "grad_hal_bias": _np(grads["hals"][0]["bias"]),
            "grad_syn_lr": float(grads["syn_lr"]),
            "dynamic": _np(new_state["dynamic"])}


def raw_mtt(plan, mode="full", seed=0, gen_seed=1):
    """One raw MTT outer step (``MTTStep``) in fp64."""
    from video_distillation_torch.distill import mtt

    gen = torch.Generator().manual_seed(seed)
    syn = torch.randn(NC, F, IM, IM, 3, generator=gen, dtype=torch.float64)
    _, t0 = mtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    _, t1 = mtt.flat_param_template("ConvNet3D", 3, NC, (IM, IM), F, gen)
    step = mtt.MTTStep("ConvNet3D", 3, NC, (IM, IM), F, STEPS, 100.0, 1e-5,
                       True, "float64", "cpu", second_order=mode)
    out = step(torch.Generator().manual_seed(gen_seed), syn,
               torch.arange(NC), torch.tensor(0.01, dtype=torch.float64),
               torch.zeros_like(syn), torch.zeros((), dtype=torch.float64),
               t0.double(), t1.double(), torch.as_tensor(plan).long())
    return {"loss": float(out[4]), "grad_images": _np(out[7]["images"]),
            "grad_syn_lr": float(out[7]["syn_lr"]), "images": _np(out[0])}


def _store(**over):
    from video_distillation_torch.data.synthetic import \
        make_synthetic_video_data

    return make_synthetic_video_data(**{**STORE, **over})


def dm_step(s2d: bool = False, shard_store: bool = False, batch_real=4,
            seed=0):
    """One raw DM or S2D-DM step in fp64 from a net, real clips and slots
    drawn from ``seed``; with ``shard_store``, the store's rows this rank
    holds."""
    from video_distillation_torch.distill import dm
    from video_distillation_torch.distill.s2d import (S2DConfig,
                                                      init_s2d_momentum)

    store = _store().train
    gen = torch.Generator().manual_seed(seed)
    if s2d:
        state, _, _ = _s2d_inputs(seed)
        state = {"static": state["static"].double(),
                 "dynamic": state["dynamic"].double(),
                 "hals": [{k: v.double() for k, v in h.items()}
                          for h in state["hals"]]}
        tr = dm.make_s2d_dm_trainer(
            store, "ConvNet3D", S2DConfig(num_classes=NC, frames=F,
                                          im_size=(IM, IM)),
            batch_real, *DM_LRS.values(), False, F, "float64", shard_store,
            "cpu")
        tr.fresh_net = lambda g, _f=tr.fresh_net: {
            k: v.double() for k, v in _f(g).items()}
        new, _, loss = tr(gen, state, init_s2d_momentum(state),
                          np.random.default_rng(seed + 1))
        out = {"loss": float(loss), "dynamic": _np(new["dynamic"]),
               "hal_weight": _np(new["hals"][0]["weight"])}
    else:
        syn = torch.randn(NC, F, IM, IM, 3, generator=gen,
                          dtype=torch.float64)
        tr = dm.make_dm_trainer(store, "ConvNet3D", 1, batch_real, 1.0, F,
                                "float64", shard_store, "cpu")
        tr.fresh_net = lambda g, _f=tr.fresh_net: {
            k: v.double() for k, v in _f(g).items()}
        state, loss = tr(gen, dm.DMState(syn, torch.arange(NC),
                                         torch.zeros_like(syn)),
                         np.random.default_rng(seed + 1))
        out = {"loss": float(loss), "images": _np(state.syn_images)}
    if shard_store:
        out["store_rows"] = int(tr.clips.local.shape[0]
                                if hasattr(tr.clips, "local")
                                else tr.clips.shape[0])
    return out


def dm_400_classes(syn, params, store_seed=0):
    """The JAX package's K400-scale sharded-store case: a 400-class image
    store of 3 images a class (16x16), one fp32 raw DM step with ConvNet
    (ipc 1, batch_real 2) from the JAX net ``params`` (flat), the store
    row-sharded over the ranks."""
    from video_distillation_torch.data.meta import DatasetMeta, register_meta
    from video_distillation_torch.data.store import ClipStore
    from video_distillation_torch.distill import dm
    from video_distillation_torch.distill.params import from_jax_params

    meta = DatasetMeta(name="shard-k400", channel=3, im_size=(16, 16),
                       num_classes=400, mean=(0.5, 0.5, 0.5),
                       std=(0.5, 0.5, 0.5), frames=1)
    register_meta(meta)
    rng = np.random.default_rng(store_seed)
    clips = rng.integers(0, 255, (400 * 3, 16, 16, 3), dtype=np.uint8)
    store = ClipStore(clips, np.repeat(np.arange(400), 3), meta)
    tr = dm.make_dm_trainer(store, "ConvNet", 1, 2, 1.0, 1,
                            shard_store=True, device="cpu")
    tr.fresh_net = lambda g: from_jax_params(tr.model, params)
    syn = torch.from_numpy(syn)
    state, loss = tr(None, dm.DMState(syn, torch.arange(400),
                                      torch.zeros_like(syn)),
                     np.random.default_rng(1))
    local = getattr(tr.clips, "local", tr.clips)
    return {"loss": float(loss), "images": _np(state.syn_images),
            "store_rows": int(local.shape[0]),
            "store_first_row": getattr(tr.clips, "start", 0)}


def frepo_step(inputs=None, dtype="float64", seed=0, ppc=1):
    """One FRePo proto step (``FRePoTrainer``, ``ppc`` prototypes a class):
    the loss, the gradients (Adam's first moments) and the updated state.
    ``inputs``: the JAX trainer's carry, real batch, pool index and static
    (fp32); else a trainer drawn from ``seed`` in ``dtype``, and then one
    pool step on net 1 (its θ and Adam moment)."""
    from video_distillation_torch.distill import frepo
    from video_distillation_torch.distill.params import frepo_carry_from_jax

    store = _store().train
    cfg = frepo.FRePoConfig(num_classes=NC, ppc=ppc, dpc=ppc, frames=F,
                            im_size=(IM, IM), num_nn_state=2,
                            max_online_updates=5, Iteration=10, batch_real=8,
                            lr_d=1.0, lr_h=1e-3, lr_net=1e-3)
    if inputs is None:
        gen = torch.Generator().manual_seed(seed)
        static = torch.randn(NC * ppc, IM, IM, 3, generator=gen).numpy()
        tr = frepo.FRePoTrainer(store, "ConvNet3D", cfg, gen, static, "cpu",
                                dtype=getattr(torch, dtype))
        real_idx = np.random.default_rng(seed).choice(len(store), 8,
                                                      replace=False)
        idx = 1
    else:
        tr = frepo.FRePoTrainer(store, "ConvNet3D", cfg, None,
                                inputs["static"], "cpu")
        tr.load_state_dict(frepo_carry_from_jax(tr.model, inputs["state0"],
                                                inputs["pool0"]))
        real_idx, idx = inputs["real_idx"], inputs["idx"]
    loss, _, _, _ = tr.proto_step(tr.pool.params(idx),
                                  torch.as_tensor(real_idx).long())
    out = {"loss": float(loss), "m": _np(tr.opt["m"]), "state": _np(tr.state)}
    if inputs is None:
        x = tr.compose_eval(torch.Generator().manual_seed(seed + 1))
        pool_loss = tr.pool.train_step(1, x, tr.state["y_syn"],
                                       np.random.default_rng(seed + 2),
                                       torch.Generator().manual_seed(seed + 3))
        out.update(pool_loss=float(pool_loss),
                   pool_params=_np(tr.pool.elements[1]["params"]),
                   pool_m=_np(tr.pool.elements[1]["m"]))
    return out


def expert_epoch(batch_train: int, dtype="float64", seed=0, inputs=None,
                 shard_store=False):
    """One epoch of expert training (``train_expert``) on a 4-class store
    of 4 clips a class: the trajectory and the accuracy. ``inputs``: the
    JAX expert's θ₀, flips and dropout mask (fp32), else drawn from
    ``seed``."""
    from video_distillation_torch.config import BufferConfig
    from video_distillation_torch.distill import buffer

    store = _store(num_classes=4, clips_per_class=4, test_per_class=1,
                   seed=1, name="synthetic_buffer_parity").train
    cfg = BufferConfig(model="ConvNet3D", train_epochs=1, lr_teacher=0.01,
                       batch_train=batch_train, mom=0.5, l2=1e-3, frames=F,
                       compute_dtype=dtype, shard_store=shard_store)
    if inputs is None:
        traj, acc = buffer.train_expert(torch.Generator().manual_seed(seed),
                                        store, cfg,
                                        np.random.default_rng(seed), "cpu")
    else:
        draws = buffer.ExpertDraws(inputs["theta"], inputs["flips"])
        masks = [[torch.from_numpy(inputs["mask"])] * len(inputs["flips"][0])]
        traj, acc = buffer.train_expert(None, store, cfg,
                                        np.random.default_rng(7), "cpu",
                                        draws, masks)
    return {"trajectory": traj, "acc": acc}


def eval_point(vmap_eval: bool, mode: str = "none", nets: int = 1,
               model: str = "ConvNet3D", seed=0):
    """One evaluation point of ``nets`` fp64 nets of ``model``
    (``evaluate_many``, one epoch; the multi-static set composed in fp32, as
    always, then cast): the trained θ and the accuracies."""
    from video_distillation_torch.distill import evaluate
    from video_distillation_torch.distill.mtt import flat_param_template
    from video_distillation_torch.distill.s2d import S2DConfig

    data = _store()
    gen = torch.Generator().manual_seed(seed)
    im = evaluate._eval_im_size(model, (IM, IM))
    thetas = [flat_param_template(model, 3, NC, im, F, gen)[1]
              .double().numpy() for _ in range(nets)]
    draws = [evaluate.EvalDraws(theta=t, perms=None) for t in thetas]
    cfg = evaluate.EvalConfig(model=model, epoch_eval_train=0, lr_net=0.01,
                              batch_train=5 if mode == "none" else 2,
                              mode=mode, test_repeats=1)
    s2d_cfg = s2d_state = syn = labels = None
    if mode == "none":
        syn = torch.randn(2 * NC, F, IM, IM, 3, generator=gen,
                          dtype=torch.float64)
        labels = torch.arange(NC).repeat_interleave(2)
    else:
        s2d_cfg = S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
        s2d_state, _, _ = _s2d_inputs(seed)
    results, mean, std = evaluate.evaluate_many(
        torch.Generator().manual_seed(seed + 1), nets, syn, labels, data, cfg,
        np.random.default_rng(seed + 2), s2d_cfg, s2d_state,
        vmap_eval=vmap_eval, draws=draws)
    return {"params": np.stack([_np(r.params) for r in results]),
            "acc_train": [r.acc_train for r in results],
            "top": [(r.top1, r.top3, r.top5) for r in results],
            "per_class": np.stack([r.acc_per_class for r in results])}


def coordinator_writes(root: str):
    """Each writer of the port into ``root/rank<r>``: only rank 0's
    files exist afterwards."""
    from video_distillation_torch.parallel import dist
    from video_distillation_torch.utils import checkpoint, visualize
    from video_distillation_torch.utils.logging import MetricLogger

    out = os.path.join(root, f"rank{dist.rank()}")
    checkpoint.save_artifact(out, "a", np.zeros(2))
    checkpoint.save_pytree_artifact(out, "b", {"w": np.zeros(2)})
    checkpoint.save_state(os.path.join(out, "ckpt"), {"x": torch.zeros(2)}, 1)
    visualize.save_image_grid(os.path.join(out, "g.png"),
                              np.zeros((1, 4, 4, 3)))
    log = MetricLogger(log_dir=out, run_name="log", quiet=True)
    log.log({"x": 1.0})
    log.finish()
    return {}


def drive_s2d(argv):
    """The S2D-MTT driver's ``main`` with ``argv``, here (world size 1)."""
    from video_distillation_torch.drivers import distill_s2d

    distill_s2d.main(argv)
    return {}

