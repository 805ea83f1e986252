"""Device time and idle time of the traced part by the program's spans.

The program names its layers with ``profiling.span`` (the names in
``video_distillation_torch.utils.profiling.SPANS``): host events on the
main thread, in the same event list as the kernels. ``attribute`` gives

* ``by_span``: device us of each kernel, copy and fill, under the
  innermost program span on the main thread whose interval holds the start
  of the host op that launched it. The attribution is by time, not by
  thread: a backward launched from autograd's device thread counts under
  the span the main thread waits in. Each kernel is counted once, under
  the op the profiler lists it with, as ``tracing.digest``'s ``conv_us``;
* ``idle_by_span``: the idle us of the traced part (no kernel, copy or
  fill on the device), under the innermost program span open when each
  gap began, ``-`` where none was.

A program without spans (one older than ``profiling.SPANS``) gives two
empty maps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import tracing

CPU = torch.autograd.DeviceType.CPU


def _innermost(spans: List, t: float):
    best = None
    for s in spans:
        if s.time_range.start <= t < s.time_range.end and (
                best is None or s.time_range.start >= best.time_range.start):
            best = s
    return None if best is None else best.name


def attribute(events, names=None) -> Tuple[Dict[str, float],
                                           Dict[str, float]]:
    """(by_span, idle_by_span) of the traced part, in us, from the
    profiler's events (``prof.events()``)."""
    if names is None:
        from video_distillation_torch.utils import profiling
        names = getattr(profiling, "SPANS", ())
    names = set(names)
    events = list(events)
    traced = [e for e in events if e.name == tracing.TRACED
              and e.device_type == CPU]
    if not traced:
        raise RuntimeError("the profiler recorded no traced span")
    w0, w1 = traced[0].time_range.start, traced[0].time_range.end
    main_thread = traced[0].thread
    spans = [e for e in events if e.name in names and e.device_type == CPU
             and e.thread == main_thread and not e.is_async]
    if not spans:
        return {}, {}
    # the spans' own device-side copies are not work
    skip = names | set(tracing.SPANS) | {tracing.TRACED}
    by_span: Dict[str, float] = {}
    for e in events:
        if (e.device_type != CPU or not w0 <= e.time_range.start < w1
                or not e.kernels):
            continue
        span = _innermost(spans, e.time_range.start)
        if span is not None:
            us = sum(k.duration for k in e.kernels if k.name not in skip)
            by_span[span] = by_span.get(span, 0.0) + us
    busy = tracing._union([
        (max(e.time_range.start, w0), min(e.time_range.end, w1))
        for e in events if tracing._is_device_work(e) and e.name not in skip
        and min(e.time_range.end, w1) > max(e.time_range.start, w0)])
    idle: Dict[str, float] = {}
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            span = _innermost(spans, t) or "-"
            idle[span] = idle.get(span, 0.0) + (a - t)
        t = max(t, b)
    return by_span, idle
