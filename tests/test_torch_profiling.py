"""The port's spans and transfer counters (``utils/profiling.py``) on the
CPU.

With no profiler recording, ``span`` is one shared no-op. Under a CPU
``torch.profiler``, two outer steps of the S2D-MTT driver list its six
distillation spans in each step's order, none overlapping another, and an
evaluation training run lists ``eval.batch`` and ``eval.update`` once a
training step, sequentially and batched. The counters move by what the
program's transfer sites hand to ``to_device`` and ``to_host``.
"""

import numpy as np
import pytest
import torch

from video_distillation_torch.config import get_preset
from video_distillation_torch.distill import evaluate as ev
from video_distillation_torch.distill.mtt import (TrajectoryBuffer,
                                                  flat_param_template)
from video_distillation_torch.distill.s2d import S2DConfig, init_s2d_state
from video_distillation_torch.drivers import distill_s2d
from video_distillation_torch.drivers.common import load_data
from video_distillation_torch.models import layers
from video_distillation_torch.utils import profiling
from video_distillation_torch.utils.logging import MetricLogger
from torch_threads import one_torch_thread  # noqa: F401

NC, F, IM = 3, 8, 64
DATASET = f"synthetic_c{NC}_n2_t1_f{F}_im{IM}"
DISTILL_SPANS = [s for s in profiling.SPANS if not s.startswith("eval.")]


@pytest.fixture(scope="module")
def buffer_dir(tmp_path_factory):
    """One expert of two epochs, from two fresh nets."""
    d = tmp_path_factory.mktemp("buffers")
    thetas = [flat_param_template("ConvNet3D", 3, NC, (IM, IM), F,
                                  torch.Generator().manual_seed(s))[1].numpy()
              for s in (0, 1)]
    TrajectoryBuffer(np.stack(thetas)[None]).save(
        str(d / "replay_buffer_0.npz"))
    return str(d)


def _profiled(fn):
    """(fn's result, the program's spans it opened in order of their start:
    [(name, start, end)])."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in profiling.SPANS)
    return out, [(n, a, b) for a, b, n in spans]


class _Spy:
    """Wraps a helper of ``profiling`` where a module calls it, keeping the
    values it returned."""

    def __init__(self, mp, module, name):
        self.fn, self.out = getattr(module, name), []
        mp.setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.out.append(out)
        return out


def _counted(fn):
    before = dict(profiling.COUNTS)
    out = fn()
    return out, {k: v - before[k] for k, v in profiling.COUNTS.items()}


def test_span_without_a_profiler_is_the_shared_noop():
    for name in profiling.SPANS:
        assert profiling.span(name) is profiling.span("x")
        with profiling.span(name):
            pass
    _, spans = _profiled(lambda: None)
    assert spans == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("driver.plan"),
                          torch.profiler.record_function)


def test_span_names_are_distinct():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS) == 8


def test_to_device_and_to_host_count_by_the_rule():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t, d = _counted(lambda: profiling.to_device(a, "cpu", torch.float32))
    assert t.dtype == torch.float32
    assert torch.equal(t, torch.from_numpy(a).float())
    # the bytes land on the device; no card, no sync
    assert d == {"host_syncs": 0, "h2d_bytes": 6 * 4}
    t, d = _counted(lambda: profiling.to_device(a, "cpu"))
    assert t.dtype == torch.int32 and d == {"host_syncs": 0, "h2d_bytes": 24}
    v, d = _counted(lambda: profiling.to_host(torch.tensor(2.5)))
    assert v == 2.5 and d == {"host_syncs": 1, "h2d_bytes": 0}
    v, d = _counted(lambda: profiling.to_host(torch.tensor([0.5, 1.0])))
    assert v == [0.5, 1.0] and d == {"host_syncs": 1, "h2d_bytes": 0}
    profiling.reset_counts()
    assert profiling.COUNTS == {"host_syncs": 0, "h2d_bytes": 0}


@pytest.mark.cuda
def test_a_copy_to_the_card_counts_a_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = np.arange(4, dtype=np.float32)
    t, d = _counted(lambda: profiling.to_device(a, "cuda"))
    assert t.is_cuda and d == {"host_syncs": 1, "h2d_bytes": 16}
    v, d = _counted(lambda: profiling.to_host(t[:2]))
    assert v == [0.0, 1.0] and d == {"host_syncs": 1, "h2d_bytes": 0}


def _driver_cfg(buffer_dir, save_dir):
    cfg = get_preset("s2d_MTT_ms")
    cfg.s2d = True
    cfg.dataset = DATASET
    cfg.buffer_path, cfg.save_path = buffer_dir, str(save_dir)
    cfg.syn_steps, cfg.Iteration, cfg.max_start_epoch = 2, 1, 1
    cfg.device = "cpu"
    return cfg


def test_distillation_steps_open_their_spans_in_order(buffer_dir, tmp_path,
                                                      monkeypatch):
    cfg = _driver_cfg(buffer_dir, tmp_path)
    dev = _Spy(monkeypatch, distill_s2d, "to_device")
    taps = _Spy(monkeypatch, layers, "to_device")
    host = _Spy(monkeypatch, distill_s2d, "to_host")
    seen = []
    (_, spans), counted = _counted(lambda: _profiled(
        lambda: distill_s2d.run(cfg, load_data(cfg), MetricLogger(quiet=True),
                                step_hook=lambda it, out: seen.append(it))))
    assert seen == [0, 1]
    step = ["driver.plan", "mtt.compose", "mtt.unroll", "mtt.outer_grad",
            "driver.segment"]
    # the first segment is drawn before the loop; step 0 logs (it % 10)
    assert [n for n, _, _ in spans] == (["driver.segment"] + step
                                        + ["driver.log"] + step)
    assert set(n for n, _, _ in spans) == set(DISTILL_SPANS)
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    # three segments of two snapshots, two plans, the second conv's tap
    # table at each inner forward; the log's two reads
    p = flat_param_template("ConvNet3D", 3, NC, (IM, IM), F)[1].numel()
    batch_syn = cfg.resolved_batch_syn(NC)
    assert len(dev.out) == 8 and len(taps.out) == 2 * cfg.syn_steps
    assert len(host.out) == 2
    assert counted == {
        "host_syncs": len(host.out),
        "h2d_bytes": sum(t.numel() * t.element_size()
                         for t in dev.out + taps.out)}
    assert counted["h2d_bytes"] == (6 * p * 4
                                    + 2 * cfg.syn_steps * batch_syn * 4
                                    + 2 * cfg.syn_steps * layers._U2.nbytes)


@pytest.fixture(scope="module")
def eval_inputs():
    meta = load_data(_driver_cfg("", "")).meta
    s2d_cfg = S2DConfig(num_classes=NC, frames=F, im_size=(IM, IM))
    state = init_s2d_state(torch.Generator().manual_seed(0), s2d_cfg, "cpu")
    cfg = ev.EvalConfig(model="ConvNet3D", epoch_eval_train=1, lr_net=0.01,
                        batch_train=2, mode="multi-static")
    return meta, cfg, s2d_cfg, state


@pytest.mark.parametrize("batched", [False, True])
def test_evaluation_steps_open_their_spans(eval_inputs, batched, monkeypatch):
    meta, cfg, s2d_cfg, state = eval_inputs
    host = _Spy(monkeypatch, ev, "to_host")
    taps = _Spy(monkeypatch, layers, "to_device")
    gen = torch.Generator().manual_seed(1)

    def call():
        if batched:
            return ev.train_synsets(gen, 2, None, None, meta, cfg, s2d_cfg,
                                    state)
        return ev.train_synset(gen, None, None, meta, cfg, s2d_cfg, state)
    (out, spans), counted = _counted(lambda: _profiled(call))
    # 2 epochs of 2 batches (3 clips in batches of 2)
    assert [n for n, _, _ in spans] == ["eval.batch", "eval.update"] * 4
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    # the accuracy's read; the tap table at each training step's forward
    assert len(host.out) == 1 and host.out[0] == out[2]
    assert len(taps.out) == 4
    assert counted == {"host_syncs": 1, "h2d_bytes": 4 * layers._U2.nbytes}
