"""S2D multi-static distillation driver (the paper's method), MTT outer loss.

Port of ``video_distillation_tpu/drivers/distill_s2d.py``: a learnable
dynamic memory and hallucinator (and optionally the static memory) are
distilled by matching expert trajectories::

    python -m video_distillation_torch.drivers.distill_s2d \\
        --preset s2d_MTT_ms --dataset miniUCF101 --buffer_path buffers \\
        [--compute_dtype bfloat16] [--device cuda]

The run is on CUDA unless ``--device cpu`` is given. ``method=DM`` and
evaluation are not ported yet (ROADMAP A.9 and A.7); a run that reaches
an evaluation iteration raises.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DistillConfig
from ..distill.buffer import load_buffers
from ..distill.mtt import ExpertSampler, S2DHyper, S2DMTTStep, make_batch_plan
from ..distill.s2d import S2DConfig, init_s2d_momentum, init_s2d_state
from ..utils.checkpoint import restore_state, save_state
from ..utils.device import resolve_device, use_exact_fp32
from ..utils.logging import MetricLogger, StepTimer
from .common import EvalTracker, load_data, parse_config_args


def step_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of outer iteration ``it`` (slot draws and dropout):
    a function of (seed, it) alone, so a resumed run draws what an
    uninterrupted one would (the JAX package's ``fold_in(key, it)``)."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + it)


def build_s2d(cfg: DistillConfig, meta, device):
    s2d_cfg = S2DConfig(num_classes=meta.num_classes, spc=cfg.spc,
                        dpc=cfg.dpc, vpc=cfg.vpc, n_hal=cfg.n_hal,
                        frames=cfg.frames, im_size=tuple(meta.im_size))
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_s2d_state(gen, s2d_cfg, device)
    if cfg.path_static:
        static = np.load(cfg.path_static)
        if static.ndim == 4 and static.shape[1] == 3:  # torch NCHW artifact
            static = np.transpose(static, (0, 2, 3, 1))
        state["static"] = torch.as_tensor(static, dtype=torch.float32,
                                          device=device).contiguous()
    return s2d_cfg, state


def run(cfg: DistillConfig, data, logger: MetricLogger,
        step_hook: Optional[Callable] = None):
    """Distil; returns {'state', 'syn_lr'}. ``step_hook(it, out)``, if
    given, is called after every outer step with the step's outputs."""
    device = resolve_device(cfg.device)
    use_exact_fp32()
    if cfg.method == "DM":
        raise NotImplementedError("S2D-DM is not ported yet (ROADMAP A.9)")
    if cfg.method != "MTT":
        raise NotImplementedError(cfg.method)
    if cfg.second_order == "remat":
        raise NotImplementedError(
            "second_order='remat': the port keeps every inner step's graph "
            "('full'); checkpointing per inner step is a ROADMAP item")
    rng = np.random.default_rng(cfg.seed)
    meta = data.meta
    s2d_cfg, state = build_s2d(cfg, meta, device)
    moms = init_s2d_momentum(state)
    ckpt_dir = os.path.join(cfg.save_path,
                            f"S2D_multis_{cfg.method}_{cfg.dataset}", "ckpt")
    holder = {"state": state,
              "syn_lr": torch.tensor(float(cfg.lr_teacher), device=device)}
    mom_lr = torch.zeros((), device=device)
    start_it = 0
    restored = restore_state(ckpt_dir, device=device)
    if restored is not None:
        st, start_it, rng_state = restored
        holder["state"], moms = st["state"], st["moms"]
        holder["syn_lr"] = st["syn_lr"]
        # mom_lr (the learnable-lr SGD momentum buffer) must round-trip for
        # exact resume
        mom_lr = st["mom_lr"]
        if rng_state:
            rng.bit_generator.state = rng_state
        start_it += 1
        print(f"resumed S2D run at iteration {start_it}")

    tracker = EvalTracker(cfg)
    timer = StepTimer()
    buffers = load_buffers(cfg.buffer_path)
    sampler = ExpertSampler(buffers, rng)
    n_syn = meta.num_classes * cfg.vpc
    batch_syn = cfg.resolved_batch_syn(meta.num_classes)
    step_fn = S2DMTTStep(
        cfg.model, meta.channel, meta.num_classes, tuple(meta.im_size),
        cfg.frames, cfg.syn_steps, s2d_cfg,
        S2DHyper(cfg.lr_static, cfg.lr_dynamic, cfg.lr_hal, cfg.lr_lr,
                 not cfg.no_train_static, cfg.train_lr),
        cfg.compute_dtype, device)

    def segment():
        t0, t1, start_epoch = sampler.sample_segment(cfg.max_start_epoch,
                                                     cfg.expert_epochs)
        return (torch.as_tensor(t0, dtype=torch.float32, device=device),
                torch.as_tensor(t1, dtype=torch.float32, device=device),
                start_epoch)

    seg = segment()
    for it in range(start_it, cfg.Iteration + 1):
        tracker.maybe_eval(it)
        theta0, theta1, start_epoch = seg
        plan = torch.as_tensor(make_batch_plan(rng, n_syn, batch_syn,
                                               cfg.syn_steps), device=device)
        out = step_fn(step_generator(cfg.seed, it, device), holder["state"],
                      holder["syn_lr"], moms, mom_lr, theta0, theta1, plan)
        seg = segment()
        holder["state"], holder["syn_lr"], moms, mom_lr = out[:4]
        timer.tick()
        if step_hook is not None:
            step_hook(it, out)
        if it % 10 == 0:
            logger.log({"Grand_Loss": float(out[4]),
                        "Start_Epoch": start_epoch,
                        "Synthetic_LR": float(holder["syn_lr"]),
                        "steps_per_sec": timer.rate()}, step=it)
        if it % 1000 == 0 and it > 0:
            save_state(ckpt_dir, {"state": holder["state"], "moms": moms,
                                  "syn_lr": holder["syn_lr"],
                                  "mom_lr": mom_lr}, it, rng)
    return holder


def main(argv=None):
    cfg = parse_config_args("S2D distillation", argv,
                            default_preset="s2d_MTT_ms")
    cfg.s2d = True
    data = load_data(cfg)
    logger = MetricLogger(log_dir=cfg.save_path,
                          run_name=f"s2d_{cfg.method}_{cfg.dataset}")
    run(cfg, data, logger)
    logger.finish()


if __name__ == "__main__":
    main()
