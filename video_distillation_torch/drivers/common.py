"""Shared driver plumbing: the config CLI, data loading, the eval tracker.

Port of ``video_distillation_tpu/drivers/common.py``: evaluate num_eval
fresh nets per model of the eval pool, track the best mean accuracy, save
artifacts on a new best (the reference's ``distill_baseline.py:146-189``).

Every driver runs under ``torchrun --nproc_per_node=N -m
video_distillation_torch.drivers.<name>``: ``parse_config_args`` joins the
launch's process group (``parallel.init_distributed``); every rank takes
part in every step and evaluation, and only the coordinator writes logs,
checkpoints and artifacts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np

from ..config import DistillConfig, get_preset
from ..data.store import VideoData, load_packed
from ..data.synthetic import (make_synthetic_video_data,
                              synthetic_kwargs_from_name)
from ..distill.evaluate import EvalConfig, evaluate_many
from ..models.registry import get_eval_pool
from ..parallel import init_distributed
from ..utils.logging import MetricLogger


# distillation drivers checkpoint every this many iterations (the JAX
# package's cadence); tests shorten it
CHECKPOINT_EVERY = 1000
# ``step_generator`` streams beside the steps' own (0, 1, ...): the
# evaluation at iteration it draws from it + EVAL_STREAM, a noise
# initialisation from INIT_STREAM
EVAL_STREAM = 10_000_000
INIT_STREAM = 20_000_000


def checkpoint_due(it: int) -> bool:
    return it % CHECKPOINT_EVERY == 0 and it > 0


def parse_config_args(description: str, argv=None,
                      default_preset: Optional[str] = None,
                      config_cls=DistillConfig):
    """Field-driven CLI over a config dataclass: any --<field> overrides its
    default (mirrors the reference sh/ wrappers passing "$@" through to
    argparse). For DistillConfig, --preset first picks the named config.
    Unknown flags are argparse errors, never silently dropped. Then joins
    the launch's process group, if ``torchrun`` started this process, on
    the config's device (as the JAX driver calls ``init_distributed``
    first)."""
    p = argparse.ArgumentParser(description=description)
    presets = config_cls is DistillConfig
    if presets:
        p.add_argument("--preset", type=str, default=default_preset)
    fields = [f for f in dataclasses.fields(config_cls)
              if f.name != "mesh_shape"]
    for f in fields:
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() == "true",
                           default=None)
        else:
            p.add_argument(f"--{f.name}",
                           type=type(f.default) if f.default is not None
                           else str, default=None)
    args = p.parse_args(argv)
    cfg = (get_preset(args.preset) if presets and args.preset
           else config_cls())
    for f in fields:
        v = getattr(args, f.name)
        if v is not None:
            setattr(cfg, f.name, v)
    init_distributed(cfg.device)
    return cfg


def load_data(cfg) -> VideoData:
    """Packed store if available, else an error with packing instructions;
    dataset names starting with 'synthetic' build a random set (tests,
    benches). Reconciles cfg.frames with the store's clip length."""
    name = cfg.dataset
    if name.startswith("synthetic"):
        data = make_synthetic_video_data(name=name,
                                         **synthetic_kwargs_from_name(name))
    else:
        packed = cfg.packed_path or os.path.join(cfg.data_path,
                                                 f"{name}_packed")
        if os.path.isdir(packed):
            data = load_packed(packed)
        else:
            raise FileNotFoundError(
                f"No packed store at {packed}. Run: python -m "
                f"video_distillation_torch.drivers.pack --dataset {name} "
                f"--data_path {cfg.data_path} --out "
                f"{os.path.dirname(packed)}")
    if getattr(cfg, "frames", None) not in (None, data.meta.frames):
        print(f"[load_data] --frames {cfg.frames} != dataset frames "
              f"{data.meta.frames}; using {data.meta.frames}")
        cfg.frames = data.meta.frames
    return data


class EvalTracker:
    """best_acc/best_std per eval model + artifact saving on new best
    (``video_distillation_tpu/drivers/common.py:90-141``).

    ``test_rng`` is ``default_rng(seed + 123)``, as in the JAX package, so
    the same seed gives the same test crops in both."""

    def __init__(self, cfg: DistillConfig, data: VideoData,
                 logger: MetricLogger, save_dir: str,
                 save_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.data = data
        self.logger = logger
        self.save_dir = save_dir
        self.save_fn = save_fn
        self.pool = get_eval_pool(cfg.eval_mode, cfg.model)
        self.best_acc: Dict[str, float] = {m: 0.0 for m in self.pool}
        self.best_std: Dict[str, float] = {m: 0.0 for m in self.pool}
        self.test_rng = np.random.default_rng(cfg.seed + 123)

    def should_eval(self, it: int) -> bool:
        cfg = self.cfg
        return it in range(cfg.startIt, cfg.Iteration + 1, cfg.eval_it)

    def maybe_eval(self, it: int, generator, syn_images, syn_labels, lr_net,
                   s2d_cfg=None, s2d_state=None) -> bool:
        """Evaluate every model of the pool with ``num_eval`` fresh nets
        trained at ``lr_net`` (the learned syn_lr, ROADMAP C.3); returns
        whether a model reached a new best."""
        cfg = self.cfg
        if not self.should_eval(it):
            return False
        save_best = False
        for model_eval in self.pool:
            ecfg = EvalConfig(
                model=model_eval, epoch_eval_train=cfg.epoch_eval_train,
                lr_net=float(lr_net), batch_train=cfg.batch_train,
                eval_mode=cfg.eval_mode,
                mode="multi-static" if s2d_state is not None else "none")
            _, mean, std = evaluate_many(
                generator, cfg.num_eval, syn_images, syn_labels, self.data,
                ecfg, self.test_rng, s2d_cfg=s2d_cfg, s2d_state=s2d_state,
                vmap_eval=cfg.vmap_eval)
            if mean > self.best_acc[model_eval]:
                self.best_acc[model_eval] = mean
                self.best_std[model_eval] = std
                save_best = True
            self.logger.log({
                f"Accuracy/{model_eval}": mean,
                f"Max_Accuracy/{model_eval}": self.best_acc[model_eval],
                f"Std/{model_eval}": std,
                f"Max_Std/{model_eval}": self.best_std[model_eval],
            }, step=it)
        if (save_best or it % 1000 == 0) and self.save_fn is not None:
            self.save_fn(it, save_best)
        return save_best
