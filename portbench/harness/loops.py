"""The loops a traffic mix names (``"loop"`` in its file), and the record of
one run.

* ``distill_s2d``: ``drivers/distill_s2d.py:run`` as users run it, one
  outer step after another. The expert buffer (``experts`` x
  ``snapshots`` from the seed) is read by the driver's own loader, and the
  initial S2D state by the driver's resume path. The first
  ``WARMUP_STEPS`` steps are set-up; the window then counts outer steps
  through ``step_hook`` and ends the run from it. The first evaluation
  (``startIt``) lies past the window.
* ``eval_train``: ``distill/evaluate.py:train_synsets`` (``"vmap": true``,
  the nets as one batched computation) or ``train_synset`` for each net in
  turn, from fresh nets each call, calls back to back; the first
  ``WARMUP_CALLS`` are set-up. A unit of work is one net's training step.

Each loop runs the window (until ``seconds`` have passed and the units it
compares are done), reads the memory, frees the program's state and then
runs the reference on what the window produced.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..reference import convnet3d as net
from ..reference import evaluate as ref_eval
from ..reference import s2d_mtt as ref_mtt
from ..roofline.kernels import Shapes
from ..roofline.peaks import card_peaks
from . import checks, inputs
from .tracing import Digest, Window

# what no traffic mix sets otherwise yet
WARMUP_STEPS = 2     # outer steps of set-up; step 2, compared, is timed
LOGITS_AMONG = 4     # the compared first forward: one of the first window steps
WARMUP_CALLS = 1     # evaluation calls of set-up
CHECK_CALLS, CHECK_AMONG = 2, 4   # calls compared, drawn among the first
TRACE_AFTER_STEPS, TRACE_STEPS = 2, 4   # window steps before / profiled
TRACE_AFTER_CALLS, TRACE_CALLS = 1, 1   # window calls before / profiled
DRIFT = 0.02         # an expert epoch's random walk, times each leaf's bound
LOGITS_STREAM = 4     # the seed's stream that draws the compared step


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""
    unit: str                      # 'outer_step' or 'eval_net_step'
    setup_s: float
    window_s: float
    units: float
    attempted: int
    failed: int
    window_peak_bytes: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    digest: Optional[Digest]
    flops_per_unit: float
    peak_flops: float
    bytes_per_s: float
    shapes: object                 # roofline.kernels.Shapes of the cell


class WindowClosed(Exception):
    pass


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters() -> Dict[str, int]:
    from video_distillation_torch.ops import hal_conv, hal_fused, phase_trio, s2d2_move
    out = {}
    for mod in (hal_conv, hal_fused, phase_trio, s2d2_move):
        out.update(mod.LAUNCHES)
    return out


def _plain(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under functorch's wrappers (a net's output inside
    ``vmap(grad(...))``), the mapped dimension first."""
    from torch._C import _functorch as ft
    while ft.is_gradtrackingtensor(t) or ft.is_batchedtensor(t):
        if ft.is_batchedtensor(t):
            t = ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0)
        else:
            t = ft.get_unwrapped(t)
    return t


class FirstForward:
    """While armed, keeps the logits of the student net's first forward:
    the first module call that returns (rows, classes), read through a
    global forward hook as the program runs."""

    def __init__(self, classes: int):
        self.classes, self.handle, self.logits = classes, None, None

    def arm(self):
        self.logits = None
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self._hook)

    def disarm(self) -> Optional[torch.Tensor]:
        if self.handle is not None:
            self.handle.remove()
            self.handle = None
        return self.logits

    def _hook(self, module, args, out):
        if (self.logits is None and isinstance(out, torch.Tensor)
                and out.dim() == 2 and out.shape[-1] == self.classes):
            self.logits = _plain(out).detach().float().clone()


def _meta(conf):
    """The dataset's description as the configuration's file gives it."""
    from video_distillation_torch.data.meta import (IMAGENET_MEAN,
                                                    IMAGENET_STD, DatasetMeta)
    m = conf["model"]
    return DatasetMeta(name=conf["dataset"], channel=m["channel"],
                       im_size=(m["im_size"], m["im_size"]),
                       num_classes=m["num_classes"], mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, frames=m["frames"])


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def mtt_setting(conf) -> ref_mtt.Setting:
    """What the reference's outer step takes from a configuration's file."""
    m, d = conf["model"], conf["distill"]
    n_syn = m["num_classes"] * d["vpc"]
    return ref_mtt.Setting(
        num_classes=m["num_classes"], channel=m["channel"],
        im_size=m["im_size"], frames=m["frames"], spc=d["spc"], dpc=d["dpc"],
        vpc=d["vpc"], syn_steps=d["syn_steps"],
        batch_syn=min(d["batch_syn"] or n_syn, n_syn),
        lr_dynamic=d["lr_dynamic"], lr_hal=d["lr_hal"], lr_lr=d["lr_lr"],
        max_start_epoch=d["max_start_epoch"],
        expert_epochs=d["expert_epochs"], train_lr=d["train_lr"])


def eval_setting(conf) -> ref_eval.EvalSetting:
    """What the reference's evaluation takes from a configuration's file."""
    m, d, e = conf["model"], conf["distill"], conf["eval"]
    return ref_eval.EvalSetting(
        num_classes=m["num_classes"], channel=m["channel"],
        im_size=m["im_size"], frames=m["frames"], spc=d["spc"], dpc=d["dpc"],
        n_hal=d["n_hal"], epoch_eval_train=e["epoch_eval_train"],
        batch_train=e["batch_train"], lr_net=e["lr_net"])


def logits_step(seed: int) -> int:
    """The outer step whose first forward is compared: one of the window's
    first ``LOGITS_AMONG``, drawn from the seed."""
    rng = np.random.default_rng((seed, LOGITS_STREAM))
    return WARMUP_STEPS + int(rng.integers(0, LOGITS_AMONG))


def distill_s2d(cell, seed: int, seconds: float, trace: bool, device,
                scratch: str, t_start: float):
    from video_distillation_torch.config import DistillConfig
    from video_distillation_torch.data.store import VideoData
    from video_distillation_torch.drivers import distill_s2d as driver
    from video_distillation_torch.utils.logging import MetricLogger

    conf, tr = cell.config, cell.traffic
    m, d = conf["model"], conf["distill"]
    im = m["im_size"]
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], im, device)
    traj = inputs.trajectories(seed, tr["experts"], tr["snapshots"], DRIFT,
                               m["channel"], m["num_classes"], device)
    buffer_path = os.path.join(scratch, "buffers")
    inputs.write_buffer(buffer_path, traj)
    cfg = DistillConfig(**d, dataset=conf["dataset"], model=m["name"],
                        frames=m["frames"], seed=seed, buffer_path=buffer_path,
                        save_path=os.path.join(scratch, "out"),
                        device=str(device))
    cfg.s2d = True
    inputs.write_resume_point(
        os.path.join(cfg.save_path, f"S2D_multis_{cfg.method}_{cfg.dataset}",
                     "ckpt"), state, cfg.lr_teacher)
    host_state = {k: v.cpu() for k, v in state.items()}
    # the trained leaves' initial values (the rate's where it is learnt)
    init = {k: host_state[k] for k in ("dynamic", "hal_w", "hal_b")}
    if cfg.train_lr:
        init["syn_lr"] = torch.tensor(float(cfg.lr_teacher))
    del state
    meta = _meta(conf)
    win = Window(seconds, device, trace, TRACE_AFTER_STEPS, TRACE_STEPS,
                 _counters)
    prog: Dict = {"losses": []}
    window_losses = []
    marks: Dict[str, float] = {}
    k_logits = logits_step(seed)
    first = FirstForward(m["num_classes"])

    class Logger(MetricLogger):
        def log(self, metrics, step=None):
            with torch.profiler.record_function("log"):
                super().log(metrics, step)

    def hook(it, out):
        win.spans.switch("hook")
        state, lr, moms, mom_lr, loss = out[:5]
        if it < 3:
            prog["losses"].append(loss)
        if it == 0:
            prog["grads"] = {"dynamic": moms["dynamic"],
                             "hal_w": moms["hals"][0]["weight"],
                             "hal_b": moms["hals"][0]["bias"],
                             "syn_lr": mom_lr}
        if it == 2:
            prog["state"] = {"dynamic": state["dynamic"],
                             "hal_w": state["hals"][0]["weight"],
                             "hal_b": state["hals"][0]["bias"],
                             "syn_lr": lr}
        if it == k_logits - 1:
            # the state the compared step starts from, copied so that the
            # memory held is the same whichever step it is
            prog["before"] = {"dynamic": state["dynamic"].clone(),
                              "hal_w": state["hals"][0]["weight"].clone(),
                              "hal_b": state["hals"][0]["bias"].clone()}
            first.arm()
        elif it == k_logits:
            prog["logits"] = first.disarm()
        if it == WARMUP_STEPS - 1:
            _sync(device)
            marks["setup_s"] = time.perf_counter() - t_start
            marks["setup_peak"] = _peak(device)
            _reset_peak(device)
            win.open()
        elif it >= WARMUP_STEPS:
            window_losses.append(loss)
            if win.tick(1) and it >= k_logits:
                raise WindowClosed
        win.spans.switch("step")

    try:
        driver.run(cfg, VideoData(meta=meta, train=None, test=None),
                   Logger(quiet=True), step_hook=hook)
    except WindowClosed:
        pass
    finally:
        first.disarm()
    if win.t1 is None:
        raise RuntimeError("the run ended before its window closed")
    window_peak = _peak(device)
    failed = sum(int(not torch.isfinite(x)) for x in window_losses)
    prog = {"losses": [float(x) for x in prog["losses"]],
            "grads": {k: v.detach().clone() for k, v in prog["grads"].items()},
            "state": {k: v.detach().clone() for k, v in prog["state"].items()},
            "before": {k: v.detach().cpu() for k, v in prog["before"].items()},
            "logits": prog.get("logits")}
    _free(device)

    setting = mtt_setting(conf)
    numbers = reference_training(setting, seed, host_state, init, traj, prog,
                                 cfg.lr_teacher, device)
    numbers["logit_gap"] = reference_logits(setting, seed, host_state, traj,
                                            prog, k_logits, device)
    shapes = Shapes(compose=setting.syn_steps * setting.batch_syn,
                    inner=setting.batch_syn, frames=m["frames"], h=im, w=im,
                    elem=2 if d["compute_dtype"] == "bfloat16" else 4)
    return _record(cell, "outer_step", marks, win, len(window_losses), failed,
                   window_peak, numbers, d["compute_dtype"], shapes, device)


def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def reference_training(setting, seed, host_state, init, traj, prog,
                       lr_teacher, device, quant=None, half_batch=False):
    """The reference's first three steps from the run's initial state, and
    the numbers compared with the program's."""
    _no_tf32()
    state = {k: v.to(device) for k, v in host_state.items()}
    ref = ref_mtt.first_steps(setting, seed, state, lr_teacher, [traj], 3,
                              device, quant, half_batch)
    return checks.training_numbers(
        prog, ref, {k: v.to(device) for k, v in init.items()})


def reference_logits(setting, seed, host_state, traj, prog, k, device
                     ) -> float:
    """``logit_gap`` of step ``k``'s first forward, the reference starting
    from the program's state before it (``prog['before']``); NaN where the
    run kept no logits."""
    if prog["logits"] is None:
        return float("nan")
    _no_tf32()
    state = {k_: v.to(device) for k_, v in host_state.items()}
    state.update({k_: v.to(device) for k_, v in prog["before"].items()})
    theta0, _, plan = ref_mtt.step_inputs(setting, seed, [traj], k, device)
    ref, valid = ref_mtt.first_logits(setting, state, theta0, plan,
                                      ref_mtt.step_generator(seed, k, device))
    return checks.logit_gap(prog["logits"], ref, valid)


def call_generator(seed: int, k: int, device) -> torch.Generator:
    """The generator of evaluation call ``k`` of a run seeded ``seed``."""
    return inputs.generator(seed * 2 ** 20 + k, inputs.CALL_STREAM, device)


def eval_train(cell, seed: int, seconds: float, trace: bool, device,
               scratch: str, t_start: float):
    from video_distillation_torch.distill import evaluate as ev
    from video_distillation_torch.distill.s2d import S2DConfig
    from video_distillation_torch.utils.device import use_exact_fp32

    use_exact_fp32()
    conf, tr = cell.config, cell.traffic
    m, d, e = conf["model"], conf["distill"], conf["eval"]
    im, nets, vmap = m["im_size"], e["num_eval"], tr["vmap"]
    meta = _meta(conf)
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
    es = eval_setting(conf)
    bt = min(es.batch_train, es.n_syn)
    per_call = nets * es.epochs * -(-es.n_syn // bt)
    rng = np.random.default_rng(seed)
    check = sorted(rng.choice(np.arange(WARMUP_CALLS, WARMUP_CALLS + CHECK_AMONG),
                              CHECK_CALLS, replace=False).tolist())
    first = FirstForward(m["num_classes"])

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
    _sync(device)
    marks = {"setup_s": time.perf_counter() - t_start,
             "setup_peak": _peak(device)}
    _reset_peak(device)
    win = Window(seconds, device, trace, TRACE_AFTER_CALLS, TRACE_CALLS,
                 _counters)
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
    window_peak = _peak(device)
    calls = k - WARMUP_CALLS
    failed = int(sum(int((~f).sum()) for f in finite)) * (per_call // nets)
    kept = {c: (t.detach().clone(), lg) for c, (t, lg) in kept.items()}
    del s2d_state
    _free(device)

    _no_tf32()
    numbers = reference_eval(es, seed, state, kept, nets, vmap, device, m)
    fold = nets * bt if vmap else bt
    shapes = Shapes(compose=fold, inner=fold, frames=m["frames"], h=im, w=im,
                    elem=4)
    return _record(cell, "eval_net_step", marks, win, calls * per_call, failed,
                   window_peak, numbers, "float32", shapes, device)


def reference_eval(es, seed, state, kept, nets, vmap, device, m, quant=None,
                   half_batch=False) -> Dict[str, float]:
    """The worst ``net_change_gap`` and ``logit_gap`` over the kept calls'
    nets ({call: (θ, first logits)}); NaN (never within a limit) where the
    window kept none."""
    split = lambda t: net.split_leaves(t, m["channel"], m["num_classes"])  # noqa: E731
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


def _record(cell, unit, marks, win, attempted, failed, window_peak, numbers,
            dtype, shapes, device) -> Run:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    peaks = card_peaks(name)
    return Run(unit=unit, setup_s=marks["setup_s"], window_s=win.elapsed,
               units=win.units, attempted=attempted, failed=failed,
               window_peak_bytes=window_peak,
               memory_peak_bytes=max(window_peak, marks["setup_peak"]),
               numbers=numbers, digest=win.digest,
               flops_per_unit=float(cell.config["flops"][unit]),
               peak_flops=peaks[dtype], bytes_per_s=peaks["bytes_per_s"],
               shapes=shapes)


LOOPS = {"distill_s2d": distill_s2d, "eval_train": eval_train}
