"""The window, its host spans, and the traced part of it.

``Window`` times the measured window on the host clock (it opens and
closes on a ``synchronize``) and, in a traced run, runs
``torch.profiler`` over a fixed number of the window's units (outer
steps, or evaluation calls) after a fixed number of them, each end
synchronised. The benchmark's own host spans (``record_function``) mark
what the harness was doing: ``step`` between two step ends, ``hook`` in
the step hook, ``log`` in the logger, ``train_call`` around an evaluation
call; ``portbench.traced`` spans the traced part.

``digest`` reduces the profiler's events to what the per-layer readers
read: the device intervals (kernels, copies, fills) and their union
inside the traced part, device time by kernel name, the device time of
the kernels launched inside a convolution op (``aten::convolution`` or
``aten::convolution_backward``; each kernel counted once, under the host
op the profiler lists it with),
the idle gaps named by the host span and outermost host op open when each
began, the launch counters of the port's ops and its transfer counters
over the traced part, and device and idle time by the program's own spans
(``spans.attribute``).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

TRACED = "portbench.traced"
SPANS = ("step", "hook", "log", "train_call")
GAPS = 10  # the longest idle gaps kept, each named
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
# first match wins; cuDNN and cuBLAS kernel names vary by version
FAMILIES = (
    ("hal", r"hal_(fwd|dgrad|wgrad|fused)"),
    ("first_stage", r"phase_(argmax|select|scatter)|s2d2_(un)?pack"),
    ("conv_gemm",
     r"conv|xmma|implicit|cutlass|gemm|sm90|sm80|dgrad|wgrad|winograd|fft|cudnn"),
    ("pool", r"pool"),
    ("reduce", r"reduce|Reduce|softmax|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|fill|copy"),
    ("memcpy_memset", r"Memcpy|Memset"),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


class Spans:
    """One open host span at a time, switched by name."""

    def __init__(self):
        self._open = None

    def switch(self, name: Optional[str]):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            self._open = torch.profiler.record_function(name)
            self._open.__enter__()


@dataclasses.dataclass
class Digest:
    window_us: float
    busy_us: float
    units: float                      # steps (or net-steps) traced
    by_kernel: Dict[str, float]       # device us by kernel name
    conv_us: float
    launches: Dict[str, int]          # the ops' launch counters
    counts: Dict[str, int]            # the program's transfer counters
    gaps: List[Tuple[str, float]]     # (what the host did, us), longest first
    by_span: Dict[str, float]         # device us by the program's span
    idle_by_span: Dict[str, float]    # idle us by the span open as it began


class Window:
    """Times the window and, if ``trace``, profiles units ``after`` to
    ``after + count`` of it (``after`` units are left to settle first) and
    takes the change of the program's launch and transfer counters
    (``launches()``, ``counts()``) over them."""

    def __init__(self, seconds: float, device, trace: bool, after: int,
                 count: int, launches: Callable[[], Dict[str, int]],
                 counts: Callable[[], Dict[str, int]]):
        self.seconds, self.device = seconds, device
        self.trace, self.after, self.count = trace, after, count
        self.launches, self.counts = launches, counts
        if trace:
            # a first read imports what the counters live in: not in the window
            launches(), counts()
        self.units = 0.0
        self.ticks = 0
        self.spans = Spans()
        self.prof = None
        self._traced = None
        self.traced_units = 0.0
        self.digest: Optional[Digest] = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self):
        self._sync()
        self.t0 = time.perf_counter()
        if self.trace and self.after == 0:
            self._start()

    def _start(self):
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._base = (dict(self.launches()), dict(self.counts()))
        self._traced = torch.profiler.record_function(TRACED)
        self._traced.__enter__()
        self.traced_units = 0.0

    def _stop(self):
        self._sync()
        self._traced.__exit__(None, None, None)
        launches = _change(self.launches(), self._base[0])
        counts = _change(self.counts(), self._base[1])
        self.spans.switch(None)
        self.prof.__exit__(None, None, None)
        self.digest = digest(self.prof.events(), self.traced_units, launches,
                             counts)
        self.prof = None

    def tick(self, units: float) -> bool:
        """Count a finished unit of ``units`` work; returns whether the
        window has closed (it never closes inside the traced part)."""
        self.units += units
        self.ticks += 1
        if self.prof is not None:
            self.traced_units += units
            if self.ticks == self.after + self.count:
                self._stop()
        elif self.trace and self.digest is None and self.ticks == self.after:
            self.spans.switch(None)
            self._start()
        if self.prof is not None:
            return False
        if time.perf_counter() - self.t0 < self.seconds:
            return False
        self._sync()
        self.t1 = time.perf_counter()
        self.spans.switch(None)
        return True

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


def _change(now: Mapping[str, int], base: Mapping[str, int]
            ) -> Dict[str, int]:
    return {k: v - base.get(k, 0) for k, v in now.items()}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _is_device_work(evt) -> bool:
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return False
    if getattr(evt, "is_user_annotation", False):
        return False
    kind = str(getattr(evt, "activity_type", "") or "").lower()
    if "annotation" in kind:
        return False
    return evt.name != TRACED and evt.name not in SPANS


def _outermost_op_at(ops, t: float) -> Optional[str]:
    best = None
    for e in ops:
        if e.time_range.start <= t < e.time_range.end:
            if best is None or e.time_range.start < best.time_range.start:
                best = e
    return None if best is None else best.name


def _under(op, names) -> bool:
    """Whether ``op`` or one of the ops it runs inside is named in ``names``."""
    while op is not None:
        if op.name in names:
            return True
        op = op.cpu_parent
    return False


def digest(events, units: float, launches: Mapping[str, int],
           counts: Mapping[str, int]) -> Digest:
    """The traced part's record from the profiler's events
    (``prof.events()``) and the counters' change over it."""
    from .spans import attribute

    events = list(events)
    traced = [e for e in events if e.name == TRACED
              and e.device_type == torch.autograd.DeviceType.CPU]
    if not traced:
        raise RuntimeError("the profiler recorded no traced span")
    w0, w1 = traced[0].time_range.start, traced[0].time_range.end
    main_thread = traced[0].thread
    device, by_kernel = [], {}
    for e in events:
        if not _is_device_work(e):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            device.append((a, b))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (b - a)
    busy = _union(device)
    # each kernel is listed once, under the host op that launched it
    conv_us = sum(k.duration for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and w0 <= e.time_range.start < w1 and _under(e, CONV_OPS)
                  for k in e.kernels)
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.thread == main_thread and not e.is_async]
    spans = [e for e in host if e.name in SPANS]
    ops = [e for e in host if e.name.startswith("aten::")
           or e.name.startswith("cuda")]
    idle, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            idle.append((a - t, t))
        t = max(t, b)
    gaps = []
    for length, start in sorted(idle, reverse=True)[:GAPS]:
        span = next((s.name for s in spans
                     if s.time_range.start <= start < s.time_range.end), "-")
        op = _outermost_op_at(ops, start)
        gaps.append((span if op is None else f"{span}:{op}", length))
    by_span, idle_by_span = attribute(events)
    return Digest(window_us=w1 - w0,
                  busy_us=sum(b - a for a, b in busy), units=units,
                  by_kernel=by_kernel, conv_us=conv_us,
                  launches=dict(launches), counts=dict(counts), gaps=gaps,
                  by_span=by_span, idle_by_span=idle_by_span)


def breakdown(d: Digest, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (by family and name) and
    the longest idle gaps, in seconds."""
    ops = sorted(d.by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[f"{family(n)}: {n[:100]}", us / 1e6]
                           for n, us in ops],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in d.gaps[:top]]}
