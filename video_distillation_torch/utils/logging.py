"""Structured metric logging.

Replaces the reference's wandb-as-config-system idiom
(the reference's ``distill_s2d_ms.py:51-61`` etc.) with a local JSONL
metric stream + stdout; wandb is attached opportunistically when available
and enabled (the scalars logged mirror the reference: Loss, Grand_Loss,
Accuracy/Max_Accuracy/Std per eval model, Synthetic_LR, Progress).
Under a process group only the coordinator (rank 0) writes or prints; the
metrics it logs are the same on every rank.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from ..parallel import dist


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 use_wandb: bool = False, project: str = "vdtpu",
                 config: Optional[dict] = None, quiet: bool = False):
        writer = dist.is_coordinator()
        self.quiet = quiet or not writer
        self._fh = None
        self._wandb = None
        if not writer:
            log_dir, use_wandb = None, False
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, name=run_name, config=config)
            except Exception as e:  # pragma: no cover
                print(f"wandb unavailable ({e}); continuing with JSONL only",
                      file=sys.stderr)

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"ts": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)
        if not self.quiet:
            parts = ", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in metrics.items())
            prefix = f"[{step}] " if step is not None else ""
            print(prefix + parts)

    def finish(self):
        if self._fh:
            self._fh.close()
        if self._wandb:
            self._wandb.finish()


class StepTimer:
    """Cheap per-phase wall-clock timer (the reference's only profiling is
    steps_per_second counters — frepo.py:484; we keep that)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self, n: int = 1):
        self.count += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.count = 0
