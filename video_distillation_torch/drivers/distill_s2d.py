"""S2D multi-static distillation driver (the paper's method), MTT outer loss.

Port of ``video_distillation_tpu/drivers/distill_s2d.py``: a learnable
dynamic memory and hallucinator (and optionally the static memory) are
distilled by matching expert trajectories::

    python -m video_distillation_torch.drivers.distill_s2d \\
        --preset s2d_MTT_ms --dataset miniUCF101 --buffer_path buffers \\
        [--compute_dtype bfloat16] [--device cuda]

The run is on CUDA unless ``--device cpu`` is given. At every evaluation
iteration (``startIt``, then every ``eval_it``) ``num_eval`` fresh
ConvNet3Ds are trained on the multi-static synthetic set at the learned
``syn_lr`` and tested; on a new best (and every 1000 iterations) the
artifacts ``dynamic_{it}.npy``, ``hal_{it}.npz`` (the JAX package's keys
and layout), ``images_{it}.npy`` (when the static memory is trained), the
``*_best`` files and PNG grids are written.

``method=DM`` (the ``s2d_DM_ms`` presets) distils by distribution
matching instead (``distill/dm.py:S2DDMTrainer``), with no buffer; its
evaluation trains at ``syn_lr``, which DM leaves at ``lr_teacher``, as the
JAX driver does::

    python -m video_distillation_torch.drivers.distill_s2d \
        --preset s2d_DM_ms --dataset miniUCF101 [--device cuda]
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DistillConfig
from ..distill.buffer import load_buffers
from ..distill.dm import make_s2d_dm_trainer
from ..distill.mtt import ExpertSampler, S2DHyper, S2DMTTStep, make_batch_plan
from ..distill.params import hal_to_jax
from ..parallel import check_mesh_shape
from ..distill.s2d import (S2DConfig, compose_synthetic, init_s2d_momentum,
                           init_s2d_state)
from ..utils.checkpoint import (restore_state, save_artifact,
                                save_pytree_artifact, save_state)
from ..utils.device import resolve_device, step_generator, use_exact_fp32
from ..utils.logging import MetricLogger, StepTimer
from ..utils.profiling import span, to_device, to_host
from ..utils.visualize import save_s2d_grids
from .common import (EVAL_STREAM, EvalTracker, checkpoint_due, load_data,
                     parse_config_args)


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
    given, is called after every outer step with the step's outputs
    (``S2DMTTStep``'s, or DM's ``(state, moms, loss)``)."""
    check_mesh_shape(cfg.mesh_shape)
    device = resolve_device(cfg.device)
    use_exact_fp32()
    if cfg.method not in ("DM", "MTT"):
        raise NotImplementedError(cfg.method)
    rng = np.random.default_rng(cfg.seed)
    meta = data.meta
    s2d_cfg, state = build_s2d(cfg, meta, device)
    moms = init_s2d_momentum(state)
    save_dir = os.path.join(cfg.save_path,
                            f"S2D_multis_{cfg.method}_{cfg.dataset}")
    ckpt_dir = os.path.join(save_dir, "ckpt")
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

    def save(it, best):
        st = holder["state"]
        dynamic = st["dynamic"].reshape((-1,) + st["dynamic"].shape[2:])
        # the hallucinator is part of the distilled set: without it the
        # output dir is not re-evaluable (hal_{it}.pt, distill_s2d_ms.py:
        # 175-193); written in the JAX package's keys and layout
        hals = [hal_to_jax(p) for p in st["hals"]]
        for tag in [str(it)] + (["best"] if best else []):
            if not cfg.no_train_static:
                save_artifact(save_dir, f"images_{tag}", st["static"])
            save_artifact(save_dir, f"dynamic_{tag}", dynamic)
            save_pytree_artifact(save_dir, f"hal_{tag}", hals)
        # PNG grids for inspection (reference capability:
        # FRePo/lib/datadistillation/utils.py:40-118)
        with torch.no_grad():
            videos, _ = compose_synthetic(
                st, s2d_cfg, generator=torch.Generator(device).manual_seed(it))
        save_s2d_grids(save_dir, it, static=st["static"].cpu().numpy(),
                       dynamic=st["dynamic"].cpu().numpy(),
                       videos=videos.cpu().numpy(), mean=meta.mean,
                       std=meta.std)

    tracker = EvalTracker(cfg, data, logger, save_dir, save)
    timer = StepTimer()

    def evaluate(it):
        if tracker.should_eval(it):
            tracker.maybe_eval(
                it, step_generator(cfg.seed, EVAL_STREAM + it, device), None,
                None, to_host(holder["syn_lr"]), s2d_cfg=s2d_cfg,
                s2d_state=holder["state"])

    def checkpoint(it):
        if checkpoint_due(it):
            save_state(ckpt_dir, {"state": holder["state"], "moms": moms,
                                  "syn_lr": holder["syn_lr"],
                                  "mom_lr": mom_lr}, it, rng)

    if cfg.method == "DM":
        trainer = make_s2d_dm_trainer(
            data.train, cfg.model, s2d_cfg, cfg.batch_real, cfg.lr_static,
            cfg.lr_dynamic, cfg.lr_hal, not cfg.no_train_static, cfg.frames,
            cfg.compute_dtype, cfg.shard_store, device)
        for it in range(start_it, cfg.Iteration + 1):
            evaluate(it)
            out = trainer(step_generator(cfg.seed, it, device),
                          holder["state"], moms, rng)
            holder["state"], moms = out[:2]
            timer.tick()
            if step_hook is not None:
                step_hook(it, out)
            if it % 100 == 0:
                logger.log({"Loss": float(out[2]) / meta.num_classes,
                            "steps_per_sec": timer.rate()}, step=it)
            checkpoint(it)
        return holder

    buffers = load_buffers(cfg.buffer_path)
    sampler = ExpertSampler(buffers, rng)
    n_syn = meta.num_classes * cfg.vpc
    batch_syn = cfg.resolved_batch_syn(meta.num_classes)
    step_fn = S2DMTTStep(
        cfg.model, meta.channel, meta.num_classes, tuple(meta.im_size),
        cfg.frames, cfg.syn_steps, s2d_cfg,
        S2DHyper(cfg.lr_static, cfg.lr_dynamic, cfg.lr_hal, cfg.lr_lr,
                 not cfg.no_train_static, cfg.train_lr),
        cfg.compute_dtype, device, cfg.second_order)

    def segment():
        with span("driver.segment"):
            t0, t1, start_epoch = sampler.sample_segment(cfg.max_start_epoch,
                                                         cfg.expert_epochs)
            return (to_device(t0, device, torch.float32),
                    to_device(t1, device, torch.float32), start_epoch)

    seg = segment()
    for it in range(start_it, cfg.Iteration + 1):
        evaluate(it)
        theta0, theta1, start_epoch = seg
        with span("driver.plan"):
            plan = to_device(make_batch_plan(rng, n_syn, batch_syn,
                                             cfg.syn_steps), device)
        out = step_fn(step_generator(cfg.seed, it, device), holder["state"],
                      holder["syn_lr"], moms, mom_lr, theta0, theta1, plan)
        seg = segment()
        holder["state"], holder["syn_lr"], moms, mom_lr = out[:4]
        timer.tick()
        if step_hook is not None:
            step_hook(it, out)
        if it % 10 == 0:
            with span("driver.log"):
                logger.log({"Grand_Loss": to_host(out[4]),
                            "Start_Epoch": start_epoch,
                            "Synthetic_LR": to_host(holder["syn_lr"]),
                            "steps_per_sec": timer.rate()}, step=it)
        checkpoint(it)
    return holder


def main(argv=None):
    cfg = parse_config_args("S2D distillation", argv,
                            default_preset="s2d_MTT_ms")
    cfg.s2d = True
    data = load_data(cfg)
    logger = MetricLogger(log_dir=cfg.save_path,
                          run_name=f"s2d_{cfg.method}_{cfg.dataset}")
    holder = run(cfg, data, logger)
    logger.finish()
    return holder


if __name__ == "__main__":
    main()
