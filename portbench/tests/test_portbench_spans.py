"""Device and idle time by the program's spans (``harness/spans.py``), on
events made up the way the profiler gives them, as the digest carries
them, and, on the card, the program's transfer counters over a traced run
of ``ucf_s2d_mtt``."""

import dataclasses
import types
import warnings

import pytest
import torch

from portbench.harness import bench, spans, tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _evt(name, start, end, device=CPU, kernels=(), thread=1, annotation=False):
    """An event as ``prof.events()`` gives it: a host op lists the kernels,
    copies and fills it launched as (name, duration)."""
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, kernels=[types.SimpleNamespace(name=n, duration=d)
                                     for n, d in kernels],
        cpu_parent=None, thread=thread, is_async=False,
        is_user_annotation=annotation,
        activity_type="gpu_user_annotation" if annotation else "kernel")


NAMES = ("driver.segment", "mtt.compose", "mtt.unroll", "mtt.outer_grad")


def _events():
    """A traced part [0, 100): the segment [0, 20) holding compose [5, 15),
    the unroll [20, 50), the outer gradient [50, 90) whose backward ops run
    on autograd's thread 2, and nothing of the program's after 90."""
    return [
        _evt(tracing.TRACED, 0, 100),
        _evt("driver.segment", 0, 20), _evt("mtt.compose", 5, 15),
        _evt("mtt.unroll", 20, 50), _evt("mtt.outer_grad", 50, 90),
        _evt("mtt.outer_grad", 51, 60, thread=2),  # not the main thread's
        _evt("aten::to", 1, 4, kernels=[("Memcpy HtoD", 3)]),
        _evt("hal_fwd", 6, 7, kernels=[("hal_fwd_kernel", 8)]),
        _evt("aten::mm", 21, 22, kernels=[("gemm", 20), ("gemm", 5)]),
        _evt("aten::mm", 52, 53, thread=2, kernels=[("gemm_bwd", 30)]),
        _evt("aten::add", 95, 96, kernels=[("add", 2)]),
        _evt("aten::mul", 110, 111, kernels=[("late", 9)]),  # after the part
        # the spans' device-side copies, listed as a host op's too
        _evt("aten::empty", 54, 55, kernels=[("mtt.outer_grad", 40)]),
        _evt("mtt.outer_grad", 50, 90, CUDA, annotation=True),
        _evt("Memcpy HtoD", 2, 5, CUDA), _evt("hal_fwd_kernel", 8, 16, CUDA),
        _evt("gemm", 22, 47, CUDA), _evt("gemm_bwd", 55, 85, CUDA),
        _evt("add", 96, 98, CUDA)]


def test_by_span_attributes_each_kernel_by_the_time_of_its_launch():
    by_span, _ = spans.attribute(_events(), NAMES)
    # the innermost span; the backward on thread 2 under the main thread's
    assert by_span == {"driver.segment": 3, "mtt.compose": 8,
                       "mtt.unroll": 25, "mtt.outer_grad": 30}


def test_idle_by_span_names_the_span_open_when_each_gap_began():
    _, idle = spans.attribute(_events(), NAMES)
    # gaps [0, 2) [5, 8) [16, 22) [47, 55) [85, 96) [98, 100)
    assert idle == {"driver.segment": 2 + 6, "mtt.compose": 3,
                    "mtt.unroll": 8, "mtt.outer_grad": 11, "-": 2}
    assert sum(idle.values()) == 100 - 3 - 8 - 25 - 30 - 2


def test_a_program_without_spans_gives_nothing():
    events = [e for e in _events() if e.name not in NAMES
              or e.device_type == CUDA]
    assert spans.attribute(events, NAMES) == ({}, {})
    assert spans.attribute(_events(), ()) == ({}, {})


def test_program_spans_leave_the_digest_as_it_was():
    """The program's spans add their attribution to the digest and change
    nothing else in it."""
    plain = [e for e in _events() if e.name not in NAMES]
    spanned = plain + [e for e in _events() if e.name in NAMES]
    a, b = (dataclasses.asdict(tracing.digest(ev, 4.0, {"hal_fwd": 1},
                                              {"host_syncs": 2}))
            for ev in (plain, spanned))
    assert (a.pop("by_span"), a.pop("idle_by_span")) == ({}, {})
    assert (b.pop("by_span"), b.pop("idle_by_span")) == spans.attribute(
        _events(), NAMES)
    assert a == b


@pytest.mark.cuda
def test_counters_match_the_syncs(card, tmp_path, monkeypatch):
    """Over the traced part of a ``ucf_s2d_mtt`` run, ``host_syncs`` equals
    the synchronising calls PyTorch flags in its sync debug mode, and is at
    least the trace's scalar reads plus pageable copies (the profiler may
    drop a record, never add one); ``h2d_bytes`` is two fp32 snapshots, an
    int32 plan and the second conv's tap table at each inner step a step;
    no span shows as device work."""
    from video_distillation_torch.models.layers import _U2
    from video_distillation_torch.utils import profiling
    kept, marks = {"caught": []}, []
    digest = tracing.digest
    start, stop = tracing.Window._start, tracing.Window._stop

    def keep(events, *args):
        kept["events"] = list(events)
        return digest(kept["events"], *args)

    def start_(self):  # after its synchronize
        start(self)
        marks.append(len(kept["caught"]))

    def stop_(self):  # before its synchronize
        marks.append(len(kept["caught"]))
        stop(self)
    monkeypatch.setattr(tracing, "digest", keep)
    monkeypatch.setattr(tracing.Window, "_start", start_)
    monkeypatch.setattr(tracing.Window, "_stop", stop_)
    cell = bench.load_cell(bench.ROOT, "ucf_s2d_mtt")
    loop = bench.loop(bench.ROOT, cell.traffic["loop"])
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kept["caught"] = caught
            run = loop.run(cell, bench.program_seed(2 ** 31 + 12345), 1.0,
                           True, card, str(tmp_path), 0.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    d, events = run.digest, kept["events"]
    flagged = sum("synchronizing" in str(w.message)
                  for w in caught[marks[0]:marks[1]])
    assert d.counts["host_syncs"] == flagged > 0
    traced = next(e for e in events if e.name == tracing.TRACED
                  and e.device_type == CPU)
    inside = [e for e in events if traced.time_range.start
              <= e.time_range.start < traced.time_range.end]
    scalar = sum(e.name == "aten::_local_scalar_dense" for e in inside
                 if e.device_type == CPU)
    pageable = sum("Memcpy" in e.name and "Pageable" in e.name
                   for e in inside if e.device_type == CUDA)
    assert 0 < scalar + pageable <= d.counts["host_syncs"]
    m, dist = cell.config["model"], cell.config["distill"]
    plan = dist["syn_steps"] * m["num_classes"] * dist["vpc"]
    assert d.counts["h2d_bytes"] == d.units * (
        8 * m["params"] + 4 * plan + dist["syn_steps"] * _U2.nbytes)
    assert not set(profiling.SPANS) & set(d.by_kernel)
    assert (d.by_span, d.idle_by_span) == spans.attribute(events)
    assert set(d.by_span) <= set(profiling.SPANS)
    assert d.by_span["mtt.unroll"] > 0 and d.by_span["mtt.outer_grad"] > 0
    assert d.launches["conv3d_s2_fprop"] > 0
