"""The ``distill_s2d`` loop: ``drivers/distill_s2d.py:run`` as users run it,
one S2D-MTT outer step after another.

The expert buffer (``experts`` x ``snapshots`` from the seed) is read by the
driver's own loader, and the initial S2D state by the driver's resume path.
The first ``WARMUP_STEPS`` steps are set-up; the window then counts outer
steps through ``step_hook`` and ends the run from it. The first evaluation
(``startIt``) lies past the window. The reference then follows the run's
first three steps and the first forward of a window step drawn from the
seed (with ``first_only``, the window's first step). ``stand_in`` puts a
control or a fault in the program's place (``portbench/calibrate.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import checks, inputs, runs, stand_ins
from portbench.harness.tracing import Window
from portbench.reference import s2d_mtt as ref_mtt
from portbench.roofline.shapes import Shapes

# what no traffic mix sets otherwise yet
WARMUP_STEPS = 2     # outer steps of set-up; step 2, compared, is timed
LOGITS_AMONG = 4     # the compared first forward: one of the first window steps
TRACE_AFTER_STEPS, TRACE_STEPS = 2, 4   # window steps before / profiled
DRIFT = 0.02         # an expert epoch's random walk, times each leaf's bound
LOGITS_STREAM = 4     # the seed's stream that draws the compared step


def mtt_setting(cell) -> ref_mtt.Setting:
    """What the reference's outer step takes from a cell's configuration."""
    m, d = cell.config["model"], cell.config["distill"]
    n_syn = m["num_classes"] * d["vpc"]
    return ref_mtt.Setting(
        net=cell.net, model=m, spc=d["spc"], dpc=d["dpc"], vpc=d["vpc"],
        syn_steps=d["syn_steps"],
        batch_syn=min(d["batch_syn"] or n_syn, n_syn),
        lr_dynamic=d["lr_dynamic"], lr_hal=d["lr_hal"], lr_lr=d["lr_lr"],
        max_start_epoch=d["max_start_epoch"],
        expert_epochs=d["expert_epochs"], train_lr=d["train_lr"])


def logits_step(seed: int, first_only: bool = False) -> int:
    """The outer step whose first forward is compared: one of the window's
    first ``LOGITS_AMONG``, drawn from the seed; the first with
    ``first_only``."""
    rng = np.random.default_rng((seed, LOGITS_STREAM))
    among = 1 if first_only else LOGITS_AMONG
    return WARMUP_STEPS + int(rng.integers(0, among))


def run(cell, seed: int, seconds: float, trace: bool, device, scratch: str,
        t_start: float, first_only: bool = False) -> runs.Run:
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
                               cell.net, m, device)
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
    meta = runs.meta(conf)
    win = Window(seconds, device, trace, TRACE_AFTER_STEPS, TRACE_STEPS,
                 runs.launches, runs.counts)
    prog: Dict = {"losses": []}
    window_losses = []
    marks: Dict[str, float] = {}
    k_logits = logits_step(seed, first_only)
    first = runs.FirstForward(m["num_classes"])

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
            runs.sync(device)
            marks["setup_s"] = time.perf_counter() - t_start
            marks["setup_peak"] = runs.peak(device)
            runs.reset_peak(device)
            win.open()
        elif it >= WARMUP_STEPS:
            window_losses.append(loss)
            if win.tick(1) and it >= k_logits:
                raise runs.WindowClosed
        win.spans.switch("step")

    try:
        driver.run(cfg, VideoData(meta=meta, train=None, test=None),
                   Logger(quiet=True), step_hook=hook)
    except runs.WindowClosed:
        pass
    finally:
        first.disarm()
    if win.t1 is None:
        raise RuntimeError("the run ended before its window closed")
    window_peak = runs.peak(device)
    failed = sum(int(not torch.isfinite(x)) for x in window_losses)
    prog = {"losses": [float(x) for x in prog["losses"]],
            "grads": {k: v.detach().clone() for k, v in prog["grads"].items()},
            "state": {k: v.detach().clone() for k, v in prog["state"].items()},
            "before": {k: v.detach().cpu() for k, v in prog["before"].items()},
            "logits": prog.get("logits")}
    runs.free(device)

    setting = mtt_setting(cell)
    numbers = reference_training(setting, seed, host_state, init, traj, prog,
                                 cfg.lr_teacher, device)
    numbers["logit_gap"] = reference_logits(setting, seed, host_state, traj,
                                            prog, k_logits, device)
    shapes = Shapes(compose=setting.syn_steps * setting.batch_syn,
                    inner=setting.batch_syn, frames=m["frames"], h=im, w=im,
                    elem=2 if d["compute_dtype"] == "bfloat16" else 4)
    return runs.record(cell, "outer_step", marks, win, len(window_losses),
                       failed, window_peak, numbers, d["compute_dtype"],
                       shapes, device)


def stand_in(cell, seed: int, device, who: str) -> Dict[str, float]:
    """The numbers of a stand-in (``harness/stand_ins.py``) put in the
    program's place: its first steps and the first forward of the window's
    first step, against the fp32 reference's."""
    conf, tr = cell.config, cell.traffic
    m, d = conf["model"], conf["distill"]
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], m["im_size"], device)
    traj = inputs.trajectories(seed, tr["experts"], tr["snapshots"], DRIFT,
                               cell.net, m, device)
    st = mtt_setting(cell)
    leaves = ["dynamic", "hal_w", "hal_b"]
    init = {k: state[k].clone() for k in leaves}
    if d["train_lr"]:
        init["syn_lr"] = torch.tensor(float(d["lr_teacher"]), device=device)
    host = {k: v.cpu() for k, v in state.items()}
    quant = stand_ins.QUANTS.get(who)
    start = stand_ins.start(state, seed, device, who)
    k = logits_step(seed, first_only=True)
    stand = ref_mtt.first_steps(st, seed, dict(start), d["lr_teacher"],
                                [traj], max(3, k), device, quant,
                                who == "half_batch")
    before = dict(start, **{x: stand[k - 1]["state"][x] for x in leaves})
    theta0, _, plan = ref_mtt.step_inputs(st, seed, [traj], k, device)
    logits, _ = ref_mtt.first_logits(st, before, theta0, plan,
                                      ref_mtt.step_generator(seed, k, device),
                                      quant)
    prog = {"losses": [float(r["loss"]) for r in stand[:3]],
            "grads": dict(stand[0]["grads"]),
            "state": dict(stand[2]["state"], syn_lr=stand[2]["syn_lr"]),
            "before": {x: before[x].cpu() for x in leaves},
            "logits": logits}
    del stand, state, start, before
    numbers = reference_training(st, seed, host, init, traj, prog,
                                 d["lr_teacher"], device)
    numbers["logit_gap"] = reference_logits(st, seed, host, traj, prog, k,
                                            device)
    return numbers


def reference_training(setting, seed, host_state, init, traj, prog,
                       lr_teacher, device, quant=None, half_batch=False):
    """The reference's first three steps from the run's initial state, and
    the numbers compared with the program's."""
    runs.no_tf32()
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
    runs.no_tf32()
    state = {k_: v.to(device) for k_, v in host_state.items()}
    state.update({k_: v.to(device) for k_, v in prog["before"].items()})
    theta0, _, plan = ref_mtt.step_inputs(setting, seed, [traj], k, device)
    ref, valid = ref_mtt.first_logits(setting, state, theta0, plan,
                                      ref_mtt.step_generator(seed, k, device))
    return checks.logit_gap(prog["logits"], ref, valid)
