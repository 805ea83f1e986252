"""Shared driver plumbing: the config CLI, data loading, the eval tracker.

Port of ``video_distillation_tpu/drivers/common.py``. Evaluation is not
ported yet (ROADMAP A.7): ``EvalTracker.maybe_eval`` raises when a run
reaches an evaluation iteration instead of skipping it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

from ..config import DistillConfig, get_preset
from ..data.store import VideoData, load_packed
from ..data.synthetic import (make_synthetic_video_data,
                              synthetic_kwargs_from_name)


def parse_config_args(description: str, argv=None,
                      default_preset: Optional[str] = None) -> DistillConfig:
    """Field-driven CLI over DistillConfig: --preset picks the named config,
    any --<field> overrides it (mirrors the reference sh/ wrappers passing
    "$@" through to argparse). Unknown flags are argparse errors, never
    silently dropped."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--preset", type=str, default=default_preset)
    for f in dataclasses.fields(DistillConfig):
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() == "true",
                           default=None)
        elif f.name != "mesh_shape":
            p.add_argument(f"--{f.name}",
                           type=type(f.default) if f.default is not None
                           else str, default=None)
    args = p.parse_args(argv)
    cfg = get_preset(args.preset) if args.preset else DistillConfig()
    for f in dataclasses.fields(DistillConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
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
                f"video_distillation_tpu.drivers.pack --dataset {name} "
                f"--data_path {cfg.data_path} --out "
                f"{os.path.dirname(packed)}")
    if getattr(cfg, "frames", None) not in (None, data.meta.frames):
        print(f"[load_data] --frames {cfg.frames} != dataset frames "
              f"{data.meta.frames}; using {data.meta.frames}")
        cfg.frames = data.meta.frames
    return data


class EvalTracker:
    """Decides the evaluation iterations (``startIt``, ``eval_it``); the
    evaluation itself is ROADMAP A.7."""

    def __init__(self, cfg: DistillConfig):
        self.cfg = cfg

    def should_eval(self, it: int) -> bool:
        cfg = self.cfg
        return it in range(cfg.startIt, cfg.Iteration + 1, cfg.eval_it)

    def maybe_eval(self, it: int, *args, **kwargs) -> bool:
        if not self.should_eval(it):
            return False
        raise NotImplementedError(
            f"iteration {it} is an evaluation iteration (startIt="
            f"{self.cfg.startIt}, eval_it={self.cfg.eval_it}), and evaluation "
            "is not ported yet (ROADMAP A.7); stop before it with "
            "--Iteration or move it with --startIt")
