"""The reduction of a trace to what the per-layer readers read, on events
made up the way the profiler gives them: the union of device intervals,
convolution time by the op that launched each kernel, named idle gaps."""

import types

import torch

from portbench.harness import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _evt(name, start, end, device=CPU, kernels=(), parent=None, thread=1):
    """An event as ``prof.events()`` gives it: a host op lists the kernels
    it launched (name, device, duration)."""
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, kernels=[types.SimpleNamespace(duration=d)
                                     for d in kernels],
        cpu_parent=parent, thread=thread, is_async=False,
        is_user_annotation=False, activity_type="kernel")


def test_digest():
    traced = _evt(tracing.TRACED, 0, 100)
    step = _evt("step", 0, 100)
    conv = _evt("aten::convolution", 5, 20, kernels=[15])
    inner = _evt("aten::cudnn_convolution", 6, 19, kernels=[30], parent=conv)
    add = _evt("aten::add", 30, 32, kernels=[5, 30])
    to = _evt("aten::to", 52, 80)  # a sync: the device runs dry
    early = _evt("aten::convolution", -30, -20, kernels=[7])  # before the span
    events = [traced, step, conv, inner, add, to, early,
              _evt("conv_kernel_a", 10, 40, CUDA),
              _evt("conv_kernel_b", 35, 50, CUDA),
              _evt("add_kernel", 50, 55, CUDA),
              _evt("step", 0, 100, CUDA),  # the span's device-side copy
              _evt("late_kernel", 90, 120, CUDA)]
    d = tracing.digest(events, 2.0, {"hal_fwd": 1}, {"host_syncs": 3})
    assert d.window_us == 100
    assert d.busy_us == 45 + 10          # [10, 55) and [90, 100)
    assert d.conv_us == 30 + 15          # both kernels under the conv op
    assert d.by_kernel["late_kernel"] == 10
    assert (d.launches, d.counts) == ({"hal_fwd": 1}, {"host_syncs": 3})
    assert d.by_span == d.idle_by_span == {}   # no span of the program
    assert d.gaps[0] == ("step:aten::to", 35)   # [55, 90)
    assert {g[1] for g in d.gaps} == {35, 10}
    out = tracing.breakdown(d)
    assert out["idle_gaps"][0] == ["step:aten::to", 35e-6]
    assert out["device_ops"][0][0].startswith("conv_gemm: conv_kernel_a")
