"""Baseline distillation driver: DM and MTT on raw synthetic tensors.

Port of ``video_distillation_tpu/drivers/distill_baseline.py`` (the
reference's ``distill_baseline.py``)::

    python -m video_distillation_torch.drivers.distill_baseline \\
        --preset DM --dataset miniUCF101 --ipc 1 --lr_img 1.0 [--device cuda]
    python -m video_distillation_torch.drivers.distill_baseline \\
        --preset MTT --dataset miniUCF101 --buffer_path buffers

The run is on CUDA unless ``--device cpu`` is given. At every evaluation
iteration (``startIt``, then every ``eval_it``) ``num_eval`` fresh nets are
trained on the synthetic set and tested: DM's at ``lr_net``, MTT's at the
learned ``syn_lr``. On a new best (and every 1000 iterations)
``images_{it}.npy``, ``images_best.npy`` and a PNG grid are written under
``<save_path>/Baseline_{DM,MTT}_<dataset>/``. A checkpoint every 1000
iterations holds the images, their momentum, ``syn_lr`` and ``mom_lr`` (MTT)
and the numpy RNG state; a run resumes from it at the next iteration. MTT
draws each iteration's expert segment at its start, so a resumed run draws
what an uninterrupted one would, except that the expert sampler's place in
the buffers is not checkpointed (as in the JAX driver).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DistillConfig
from ..distill.buffer import load_buffers
from ..distill.dm import DMState, init_synthetic_raw, make_dm_trainer
from ..distill.mtt import ExpertSampler, MTTStep, make_batch_plan
from ..parallel import check_mesh_shape
from ..utils.checkpoint import restore_state, save_artifact, save_state
from ..utils.device import resolve_device, step_generator, use_exact_fp32
from ..utils.logging import MetricLogger, StepTimer
from ..utils.visualize import save_video_grid
from .common import (EVAL_STREAM, INIT_STREAM, EvalTracker, checkpoint_due,
                     load_data, parse_config_args)


def _init(cfg: DistillConfig, data, device, rng):
    gen = step_generator(cfg.seed, INIT_STREAM, device)
    return init_synthetic_raw(gen, data.train, cfg.ipc, cfg.frames, cfg.init,
                              rng, device)


def _saver(save_dir, holder, meta):
    def save(it, best):
        for tag in [str(it)] + (["best"] if best else []):
            save_artifact(save_dir, f"images_{tag}", holder["syn"])
        save_video_grid(os.path.join(save_dir, "png",
                                     f"videos_{str(it).zfill(6)}.png"),
                        holder["syn"].cpu().numpy(), mean=meta.mean,
                        std=meta.std)
    return save


def _resume(ckpt_dir, device, rng, what):
    restored = restore_state(ckpt_dir, device=device)
    if restored is None:
        return None, 0
    st, start_it, rng_state = restored
    if rng_state:
        rng.bit_generator.state = rng_state
    print(f"resumed {what} run at iteration {start_it + 1}")
    return st, start_it + 1


def run_dm(cfg: DistillConfig, data, logger: MetricLogger,
           step_hook: Optional[Callable] = None) -> DMState:
    """DM on the raw tensor; returns the final state. ``step_hook(it,
    (state, loss))``, if given, is called after every step."""
    check_mesh_shape(cfg.mesh_shape)
    device = resolve_device(cfg.device)
    use_exact_fp32()
    rng = np.random.default_rng(cfg.seed)
    syn, labels = _init(cfg, data, device, rng)
    holder = {"syn": syn, "mom": torch.zeros_like(syn)}
    trainer = make_dm_trainer(data.train, cfg.model, cfg.ipc, cfg.batch_real,
                              cfg.lr_img, cfg.frames, cfg.compute_dtype,
                              cfg.shard_store, device)
    save_dir = os.path.join(cfg.save_path, f"Baseline_DM_{cfg.dataset}")
    ckpt_dir = os.path.join(save_dir, "ckpt")
    st, start_it = _resume(ckpt_dir, device, rng, "DM")
    if st is not None:
        holder.update(syn=st["syn"], mom=st["mom"])

    tracker = EvalTracker(cfg, data, logger, save_dir,
                          _saver(save_dir, holder, data.meta))
    timer = StepTimer()
    for it in range(start_it, cfg.Iteration + 1):
        tracker.maybe_eval(it, step_generator(cfg.seed, EVAL_STREAM + it, device),
                           holder["syn"], labels, cfg.lr_net)
        state, loss = trainer(step_generator(cfg.seed, it, device),
                              DMState(holder["syn"], labels, holder["mom"]), rng)
        holder.update(syn=state.syn_images, mom=state.momentum)
        timer.tick()
        if step_hook is not None:
            step_hook(it, (state, loss))
        if it % 100 == 0:
            logger.log({"Loss": float(loss) / data.meta.num_classes,
                        "steps_per_sec": timer.rate()}, step=it)
        if checkpoint_due(it):
            save_state(ckpt_dir, {"syn": holder["syn"], "mom": holder["mom"]},
                       it, rng)
    return DMState(holder["syn"], labels, holder["mom"])


def run_mtt(cfg: DistillConfig, data, logger: MetricLogger,
            step_hook: Optional[Callable] = None):
    """MTT on the raw tensor; returns (syn_images, labels, syn_lr).
    ``step_hook(it, out)``, if given, is called after every outer step with
    ``MTTStep``'s outputs."""
    check_mesh_shape(cfg.mesh_shape)
    device = resolve_device(cfg.device)
    use_exact_fp32()
    meta = data.meta
    rng = np.random.default_rng(cfg.seed)
    syn, labels = _init(cfg, data, device, rng)
    n_syn = syn.shape[0]
    batch_syn = cfg.resolved_batch_syn(meta.num_classes)
    sampler = ExpertSampler(load_buffers(cfg.buffer_path), rng)
    step_fn = MTTStep(cfg.model, meta.channel, meta.num_classes,
                      tuple(meta.im_size), cfg.frames, cfg.syn_steps,
                      cfg.lr_img, cfg.lr_lr, cfg.train_lr, cfg.compute_dtype,
                      device, cfg.second_order)
    holder = {"syn": syn,
              "syn_lr": torch.tensor(float(cfg.lr_teacher), device=device),
              "mom_img": torch.zeros_like(syn),
              "mom_lr": torch.zeros((), device=device)}
    save_dir = os.path.join(cfg.save_path, f"Baseline_MTT_{cfg.dataset}")
    ckpt_dir = os.path.join(save_dir, "ckpt")
    st, start_it = _resume(ckpt_dir, device, rng, "MTT")
    if st is not None:
        holder.update(st)

    tracker = EvalTracker(cfg, data, logger, save_dir,
                          _saver(save_dir, holder, meta))
    timer = StepTimer()
    for it in range(start_it, cfg.Iteration + 1):
        if tracker.should_eval(it):
            tracker.maybe_eval(
                it, step_generator(cfg.seed, EVAL_STREAM + it, device),
                holder["syn"], labels, float(holder["syn_lr"]))
        theta0, theta1, start_epoch = sampler.sample_segment(
            cfg.max_start_epoch, cfg.expert_epochs)
        plan = torch.as_tensor(make_batch_plan(rng, n_syn, batch_syn,
                                               cfg.syn_steps), device=device)
        out = step_fn(step_generator(cfg.seed, it, device), holder["syn"],
                      labels, holder["syn_lr"], holder["mom_img"],
                      holder["mom_lr"],
                      torch.as_tensor(theta0, dtype=torch.float32, device=device),
                      torch.as_tensor(theta1, dtype=torch.float32, device=device),
                      plan)
        holder.update(zip(("syn", "syn_lr", "mom_img", "mom_lr"), out[:4]))
        timer.tick()
        if step_hook is not None:
            step_hook(it, out)
        if it % 50 == 0:
            logger.log({"Grand_Loss": float(out[4]),
                        "Start_Epoch": start_epoch,
                        "Synthetic_LR": float(holder["syn_lr"]),
                        "steps_per_sec": timer.rate()}, step=it)
        if checkpoint_due(it):
            save_state(ckpt_dir, dict(holder), it, rng)
    return holder["syn"], labels, holder["syn_lr"]


def main(argv=None, logger: Optional[MetricLogger] = None,
         step_hook: Optional[Callable] = None):
    """Parse the flags, load the data and run DM or MTT; returns what
    ``run_dm`` / ``run_mtt`` return."""
    cfg = parse_config_args("DM/MTT baseline distillation", argv)
    data = load_data(cfg)
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(log_dir=cfg.save_path,
                              run_name=f"{cfg.method}_{cfg.dataset}_ipc{cfg.ipc}")
    if cfg.method == "DM":
        out = run_dm(cfg, data, logger, step_hook)
    elif cfg.method == "MTT":
        out = run_mtt(cfg, data, logger, step_hook)
    else:
        raise NotImplementedError(cfg.method)
    if own_logger:
        logger.finish()
    return out


if __name__ == "__main__":
    main()
