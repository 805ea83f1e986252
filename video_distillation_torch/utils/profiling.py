"""Profiling hooks: named spans, transfer counters and ``torch.profiler``
traces.

Port of ``video_distillation_tpu/utils/profiling.py``. ``span`` names a
block of the program in a trace: with a profiler recording it is a
``torch.profiler.record_function`` range, a host event in the same event
list as the kernels and so on one clock with the device trace; with none
it is a shared no-op, behind one flag check, since ``record_function``
costs microseconds a call even with the profiler off. ``SPANS`` holds the
names the program opens. ``trace`` records a block and writes it as a
Chrome trace, the program's spans and the kernels on one timeline.

``COUNTS`` counts the program's transfers between the host and the
device, always on, as the ops' ``LAUNCHES`` count launches:
``to_device`` (a copy from host memory) adds its bytes to ``h2d_bytes``
and, where the target is a card, one ``host_syncs``: PyTorch's blocking
copy to a card waits for the stream (``at::cuda::memcpy_and_sync``);
``to_host`` (a read of a tensor's values) adds one ``host_syncs``.
"""

from __future__ import annotations

import contextlib
import os

import torch

SPANS = (
    "driver.segment",     # drivers/distill_s2d.py: an expert segment, copied
    "driver.plan",        # the outer step's batch plan, copied
    "driver.log",         # the logger's reads and its write
    "mtt.compose",        # distill/mtt.py: slot draws, gathers, hallucinate
    "mtt.unroll",         # the inner steps and the grand loss
    "mtt.outer_grad",     # the outer gradients and their all-reduce
    "eval.batch",         # distill/evaluate.py: a training batch, composed
    "eval.update",        # the nets' optimizer step
)

COUNTS = {"host_syncs": 0, "h2d_bytes": 0}

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A named span in the trace around a block; the shared no-op while no
    profiler records."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``array`` (a numpy array or a host tensor) as a tensor on
    ``device``, counted."""
    out = torch.as_tensor(array, dtype=dtype, device=device)
    COUNTS["h2d_bytes"] += out.nbytes
    if out.is_cuda:
        COUNTS["host_syncs"] += 1
    return out


def to_host(tensor: torch.Tensor):
    """A tensor's values on the host (a Python number for one element,
    nested lists otherwise), counted as a sync."""
    COUNTS["host_syncs"] += 1
    return tensor.tolist()


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
