"""The ``eval_train`` loop: ``distill/evaluate.py:train_synsets`` (``"vmap":
true``, the nets as one batched computation) or ``train_synset`` for each
net in turn, from fresh nets each call, calls back to back.

The first ``WARMUP_CALLS`` are set-up. A unit of work is one net's
training step. The reference then trains ``CHECK_CALLS`` of the window's
first ``CHECK_AMONG`` calls, drawn from the seed (with ``first_only``, the
window's first call), again from the same init and draws. ``stand_in``
puts a control or a fault in the program's place
(``portbench/calibrate.py``).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import checks, inputs, runs, stand_ins
from portbench.harness.tracing import Window
from portbench.reference import evaluate as ref_eval
from portbench.reference import ops
from portbench.roofline.shapes import Shapes

# what no traffic mix sets otherwise yet
WARMUP_CALLS = 1     # evaluation calls of set-up
CHECK_CALLS, CHECK_AMONG = 2, 4   # calls compared, drawn among the first
TRACE_AFTER_CALLS, TRACE_CALLS = 1, 1   # window calls before / profiled


def eval_setting(cell) -> ref_eval.EvalSetting:
    """What the reference's evaluation takes from a cell's configuration."""
    m, d, e = (cell.config[k] for k in ("model", "distill", "eval"))
    return ref_eval.EvalSetting(
        net=cell.net, model=m, spc=d["spc"], dpc=d["dpc"], n_hal=d["n_hal"],
        epoch_eval_train=e["epoch_eval_train"], batch_train=e["batch_train"],
        lr_net=e["lr_net"])


def call_generator(seed: int, k: int, device) -> torch.Generator:
    """The generator of evaluation call ``k`` of a run seeded ``seed``."""
    return inputs.generator(seed * 2 ** 20 + k, inputs.CALL_STREAM, device)


def checked_calls(seed: int, first_only: bool = False):
    """The window's calls that the reference trains again."""
    if first_only:
        return [WARMUP_CALLS]
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(np.arange(WARMUP_CALLS, WARMUP_CALLS + CHECK_AMONG),
                             CHECK_CALLS, replace=False).tolist())


def run(cell, seed: int, seconds: float, trace: bool, device, scratch: str,
        t_start: float, first_only: bool = False) -> runs.Run:
    from video_distillation_torch.distill import evaluate as ev
    from video_distillation_torch.distill.s2d import S2DConfig
    from video_distillation_torch.utils.device import use_exact_fp32

    use_exact_fp32()
    conf, tr = cell.config, cell.traffic
    m, d, e = conf["model"], conf["distill"], conf["eval"]
    im, nets, vmap = m["im_size"], e["num_eval"], tr["vmap"]
    meta = runs.meta(conf)
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], im, device)
    s2d_cfg = S2DConfig(num_classes=m["num_classes"], spc=d["spc"],
                        dpc=d["dpc"], vpc=d["vpc"], n_hal=d["n_hal"],
                        frames=m["frames"], im_size=(im, im))
    s2d_state = {"static": state["static"], "dynamic": state["dynamic"],
                 "hals": [{"weight": state["hal_w"], "bias": state["hal_b"]}]}
    ecfg = ev.EvalConfig(model=m["name"], epoch_eval_train=e["epoch_eval_train"],
                         lr_net=e["lr_net"], batch_train=e["batch_train"],
                         eval_mode=e["eval_mode"], mode="multi-static")
    es = eval_setting(cell)
    bt = min(es.batch_train, es.n_syn)
    per_call = nets * es.epochs * -(-es.n_syn // bt)
    check = checked_calls(seed, first_only)
    first = runs.FirstForward(m["num_classes"])

    def train(gen, watch, fn):
        if watch:
            first.arm()
        try:
            theta = fn(gen)
        finally:
            logits = first.disarm()
        return theta, logits

    def call(k):
        """(θ (nets, P), the logits of the nets' first step where the call
        is compared: (nets, rows, classes) sequentially, the first batched
        computation's nets under vmap)."""
        gen, watch = call_generator(seed, k, device), k in check
        with torch.profiler.record_function("train_call"):
            if vmap:
                return train(gen, watch, lambda g: ev.train_synsets(
                    g, nets, None, None, meta, ecfg, s2d_cfg, s2d_state)[0])
            out = [train(gen, watch, lambda g: ev.train_synset(
                g, None, None, meta, ecfg, s2d_cfg, s2d_state)[0])
                for _ in range(nets)]
            logits = (torch.stack([lg for _, lg in out]) if watch else None)
            return torch.stack([t for t, _ in out]), logits

    for k in range(WARMUP_CALLS):
        call(k)
    runs.sync(device)
    marks = {"setup_s": time.perf_counter() - t_start,
             "setup_peak": runs.peak(device)}
    runs.reset_peak(device)
    win = Window(seconds, device, trace, TRACE_AFTER_CALLS, TRACE_CALLS,
                 runs.launches, runs.counts)
    win.open()
    kept, finite, k = {}, [], WARMUP_CALLS
    while True:
        theta, logits = call(k)
        finite.append(torch.isfinite(theta).all(dim=1))
        if k in check:
            kept[k] = (theta, logits)
        k += 1
        if win.tick(per_call) and k > check[-1]:
            break
    window_peak = runs.peak(device)
    calls = k - WARMUP_CALLS
    failed = int(sum(int((~f).sum()) for f in finite)) * (per_call // nets)
    kept = {c: (t.detach().clone(), lg) for c, (t, lg) in kept.items()}
    del s2d_state
    runs.free(device)

    runs.no_tf32()
    numbers = reference_eval(es, seed, state, kept, nets, vmap, device)
    fold = nets * bt if vmap else bt
    shapes = Shapes(compose=fold, inner=fold, frames=m["frames"], h=im, w=im,
                    elem=4)
    return runs.record(cell, "eval_net_step", marks, win, calls * per_call,
                       failed, window_peak, numbers, "float32", shapes, device)


def stand_in(cell, seed: int, device, who: str) -> Dict[str, float]:
    """The numbers of a stand-in (``harness/stand_ins.py``) put in the
    program's place: the window's first call's nets against the fp32
    reference's."""
    m, d, e = (cell.config[k] for k in ("model", "distill", "eval"))
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], m["im_size"], device)
    es = eval_setting(cell)
    k, vmap = WARMUP_CALLS, cell.traffic["vmap"]
    tf32 = who not in stand_ins.FAULTS
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    start = stand_ins.start(state, seed, device, who)
    stand = ref_eval.train_nets(es, start, call_generator(seed, k, device),
                                e["num_eval"], vmap, device,
                                half_batch=who == "half_batch")
    kept = {k: (torch.stack([r["theta"] for r in stand]),
                torch.stack([r["logits0"] for r in stand]))}
    runs.no_tf32()
    return reference_eval(es, seed, state, kept, e["num_eval"], vmap, device)


def reference_eval(es, seed, state, kept, nets, vmap, device, quant=None,
                   half_batch=False) -> Dict[str, float]:
    """The worst ``net_change_gap`` and ``logit_gap`` over the kept calls'
    nets ({call: (θ, first logits)}); NaN (never within a limit) where the
    window kept none."""
    leaves = es.net.leaves(es.model)
    split = lambda t: ops.split(t, leaves)  # noqa: E731
    worst = {"net_change_gap": float("nan"), "logit_gap": float("nan")}

    def note(key, gap):
        if math.isnan(worst[key]) or not gap <= worst[key]:
            worst[key] = gap

    for k, (theta, logits) in kept.items():
        ref = ref_eval.train_nets(es, state, call_generator(seed, k, device),
                                  nets, vmap, device, quant, half_batch)
        for e, r in enumerate(ref):
            note("net_change_gap",
                 checks.net_change_gap(theta[e], r["theta"], r["init"], split))
            if logits is not None and e < logits.shape[0]:
                valid = torch.ones(logits.shape[1], dtype=torch.bool)
                note("logit_gap", checks.logit_gap(logits[e], r["logits0"],
                                                   valid))
    return worst
