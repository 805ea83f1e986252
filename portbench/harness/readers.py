"""The metric readers that ``portbench/metrics/<metric>.py`` name. Each
takes the run's record (``runs.Run``), whose ``unit`` is the work its
cell counts (an outer step, or one net's training step), and returns None
where the run has nothing for it to read."""

from __future__ import annotations

import re
from typing import Optional

from . import registry


def rate(run) -> Optional[float]:
    """Units of work completed over the window's whole wall time."""
    if run.window_s <= 0:
        return None
    return run.units / run.window_s


def _traced(run):
    d = run.digest
    if d is None or d.units <= 0 or d.window_us <= 0:
        return None
    return d


def mfu(run) -> Optional[float]:
    """The model FLOPs of the traced units over the traced time at the
    card's dense peak for the configuration's precision, in %."""
    d = _traced(run)
    if d is None:
        return None
    return 100.0 * run.flops_per_unit * d.units / (d.window_us * 1e-6
                                                   * run.peak_flops)


def conv_ms(run) -> Optional[float]:
    """Device ms under the convolution ops, per unit of work."""
    d = _traced(run)
    if d is None or d.conv_us <= 0:
        return None
    return d.conv_us / 1e3 / d.units


def kernels_roofline(run) -> Optional[float]:
    """Σ launches x bound over Σ device time of the port's kernels that
    have a roofline entry (``roofline/kernels/<counter>.py``: its kernels'
    names and the least time a launch takes) in the traced units, in %."""
    d = _traced(run)
    if d is None:
        return None
    entries = registry.every(run.root, "roofline/kernels")
    bound = sum(d.launches.get(k, 0) * e.bound(run.shapes, run.config,
                                               run.peaks)
                for k, e in entries.items())
    pattern = re.compile("|".join(e.PATTERN for e in entries.values()))
    spent = sum(us for name, us in d.by_kernel.items()
                if pattern.search(name)) * 1e-6
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def idle(run) -> Optional[float]:
    """The share of the traced time with no kernel, copy or fill on the
    device, in %."""
    d = _traced(run)
    if d is None:
        return None
    return 100.0 * (1.0 - d.busy_us / d.window_us)


def count(run, name: str) -> Optional[float]:
    """The program's counter ``name`` (``utils/profiling.COUNTS``) over the
    traced part, per unit of work."""
    d = _traced(run)
    if d is None or name not in d.counts:
        return None
    return d.counts[name] / d.units


def idle_ms(run, prefix: str) -> Optional[float]:
    """Idle ms per unit of work in the traced part, in the gaps that began
    inside a program span whose name starts with ``prefix``; None for a
    program without spans."""
    d = _traced(run)
    if d is None or not d.idle_by_span:
        return None
    us = sum(v for k, v in d.idle_by_span.items() if k.startswith(prefix))
    return us / 1e3 / d.units
