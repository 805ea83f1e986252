"""Profiling hooks: ``torch.profiler`` traces and phase timers.

Port of ``video_distillation_tpu/utils/profiling.py``: ``trace`` records
the host and, where there is one, the card around a block and writes a
Chrome trace; ``annotate`` names a span in it; ``timed`` times a call and
waits for the card when an output lies on it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block (CPU, and CUDA when available) and write it as
    ``trace.json`` (Chrome's format) under ``log_dir``; yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the trace around a block."""
    return torch.profiler.record_function(name)


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(v) for v in out)
    return False


def timed(fn, *args, sync: bool = True, **kwargs):
    """(result, seconds); with ``sync``, waits for the card to finish when
    an output is on it, so the seconds include the device work."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync and _on_card(out):
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
