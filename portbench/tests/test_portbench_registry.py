"""What a cell is made of is found by name: a copy of the benchmark takes a
second student net (VideoConvNetMean), a loop, a kernel's roofline and a
metric that reads the program's spans and counters as new files only, and
its cells run correct through the harness on the CPU. The files that moved
behind the lookups compute what they computed before: ConvNet3D's
reference, the nine kernels' bounds, the toy cells' checks."""

import copy
import hashlib
import inspect
import json
import os
import shutil
import time
import types

import pytest
import torch
from torch.func import functional_call

from portbench.harness import bench, readers, registry
from portbench.reference.ops import num_params
from portbench.roofline.peaks import card_peaks
from portbench.roofline.shapes import Shapes
from portbench.tests import toy

ROOT = bench.ROOT
CPU = torch.device("cpu")
SXM = card_peaks("NVIDIA H100 80GB HBM3")

VIDEO_MODEL = {"name": "VideoConvNetMean", "channel": 3, "num_classes": 3,
               "im_size": 64, "frames": 8, "net_width": 128, "net_depth": 3,
               "net_act": "relu", "net_norm": "instancenorm",
               "net_pooling": "avgpooling"}
VIDEO_CONFIG = dict(copy.deepcopy(toy.TOY_CONFIG), name="toy_video_mean",
                    model=VIDEO_MODEL,
                    flops={"eval_net_step": 1.0, "forward": 1.0})
VIDEO_CELLS = {  # cell: (traffic, limits)
    "toy_video_vmap": ({"loop": "eval_train", "vmap": True},
                       "ucf_eval_vmap"),
    "toy_video_seq": ({"loop": "eval_train", "vmap": False}, "ucf_eval_seq"),
    "toy_video_fwd": ({"loop": "toy_forward"}, {"logit_gap": 1e-5}),
}
TOY_LOOP = '''"""A loop kind of its own: one fresh student net's forward on a batch
of clips from the seed, a unit a forward, its logits against the
reference's."""

import time

import torch
from torch.func import functional_call

from portbench.harness import checks, inputs, runs
from portbench.harness.tracing import Window
from portbench.roofline.shapes import Shapes


def run(cell, seed, seconds, trace, device, scratch, t_start):
    from video_distillation_torch.distill.evaluate import fresh_net
    m, net = cell.config["model"], cell.net
    g = inputs.generator(seed, 5, device)
    x = net.prepare(torch.randn((4, m["frames"], m["im_size"], m["im_size"],
                                 3), generator=g, device=device), m)
    size = tuple(x.shape[2:4])
    model, theta, layout = fresh_net(
        m["name"], runs.meta(cell.config), m["frames"],
        inputs.generator(seed, 6, device), device, im_size=size)
    marks = {"setup_s": time.perf_counter() - t_start, "setup_peak": 0}
    win = Window(seconds, device, trace, 1, 1, runs.launches, runs.counts)
    win.open()
    while True:
        logits = functional_call(model, layout.unflatten(theta), (x,),
                                 dict(train=False))
        if win.tick(1):
            break
    ref = net.forward(net.unflatten(net.init_theta(
        inputs.generator(seed, 6, device), m, device), m), x, m)
    numbers = {"logit_gap": checks.logit_gap(
        logits, ref, torch.ones(len(x), dtype=torch.bool))}
    shapes = Shapes(compose=4, inner=4, frames=m["frames"], h=size[0],
                    w=size[1], elem=4)
    return runs.record(cell, "forward", marks, win, int(win.units), 0, 0,
                       numbers, "float32", shapes, device)
'''
TOY_ENTRY = '''"""A made-up kernel bound by its operations: 1 GFLOP a launch."""

PATTERN = r"toy_kernel"


def bound(s, config, peaks):
    return 1e9 / peaks["bfloat16"]
'''
TOY_READER = '''"""Host syncs a traced unit, where the program's spans were seen."""


def read(run):
    d = run.digest
    if d is None or not (d.by_span or d.idle_by_span):
        return None
    return d.counts.get("host_syncs", 0) / d.units
'''


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    """A toy copy of the benchmark with the second net's cells, a loop, a
    roofline entry and a metric added as new files."""
    dest = toy.make_copy(str(tmp_path_factory.mktemp("video")))
    pb = os.path.join(dest, "portbench")
    _write(os.path.join(pb, "configs", "toy_video_mean.json"),
           json.dumps(VIDEO_CONFIG))
    _write(os.path.join(pb, "loops", "toy_forward.py"), TOY_LOOP)
    _write(os.path.join(pb, "roofline", "kernels", "toy_kernel.py"), TOY_ENTRY)
    _write(os.path.join(pb, "metrics", "toy_spans.py"), TOY_READER)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "toy_video_mean", "source": "test",
                         "file": "portbench/configs/toy_video_mean.json",
                         "reduced": [], "why": "a CPU test"})
    for cell, (traffic, limits) in VIDEO_CELLS.items():
        _write(os.path.join(pb, "traffic", f"{cell}.json"), json.dumps(traffic))
        if isinstance(limits, str):
            shutil.copy(os.path.join(pb, "limits", f"{limits}.json"),
                        os.path.join(pb, "limits", f"{cell}.json"))
        else:
            _write(os.path.join(pb, "limits", f"{cell}.json"),
                   json.dumps(limits))
        b["workloads"].append({"name": cell, "config": "toy_video_mean",
                               "traffic": cell, "chips": 1,
                               "why": "a CPU test"})
    for m in b["end_to_end"]:
        if m["name"] == "toy_units":
            m["workloads"] += list(VIDEO_CELLS)
    b["per_layer"].append({"name": "toy_spans", "unit": "syncs/step",
                           "better": "lower", "source": "program_counter",
                           "layer": "driver loop",
                           "moves": "eval_net_steps_per_s",
                           "workloads": ["toy_video_vmap"]})
    _write(os.path.join(dest, "BENCHMARK.json"), json.dumps(b))
    return dest


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_copy_adds_files_and_edits_none(video_root):
    added = set()
    for d, _, files in os.walk(os.path.join(video_root, "portbench")):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), video_root)
            if "__pycache__" in rel:
                continue
            if os.path.exists(os.path.join(ROOT, rel)):
                assert _digest(os.path.join(ROOT, rel)) == _digest(
                    os.path.join(video_root, rel)), rel
            else:
                added.add(rel)
    assert {"portbench/configs/toy_video_mean.json",
            "portbench/loops/toy_forward.py",
            "portbench/roofline/kernels/toy_kernel.py",
            "portbench/metrics/toy_spans.py"} <= added
    assert not any(p.startswith("portbench/reference/") for p in added)


def _run(root, workload, trace=0, seed=2 ** 31 + 7):
    args = bench.parse(["--workload", workload, "--seed", str(seed),
                        "--seconds", "0.2", "--trace", str(trace)])
    rc, line = bench.run_cell(root, args, time.perf_counter(), device=CPU)
    assert rc == 0
    return line


@pytest.mark.parametrize("workload", list(VIDEO_CELLS))
def test_the_second_nets_cells_are_correct(video_root, workload):
    line = _run(video_root, workload)
    assert line["correct"], line["checks"]
    assert line["metrics"]["toy_units"]["value"] > 0


def test_a_metric_reads_the_programs_spans_and_counters(video_root):
    line = _run(video_root, "toy_video_vmap", trace=1)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"toy_spans"}
    assert line["metrics"]["toy_spans"]["value"] > 0


def test_a_roofline_entry_is_summed(video_root):
    """``kernels_roofline`` sums the entries it finds: the copy's own entry
    joins the nine kernels' and ``conv3d_s2``'s."""
    shapes = Shapes(compose=500, inner=50, frames=16, h=112, w=112, elem=2)
    config = bench.load_cell(ROOT, "ucf_s2d_mtt").config
    digest = types.SimpleNamespace(
        units=1.0, window_us=1e6, launches={"hal_fwd": 2, "toy_kernel": 3},
        by_kernel={"hal_fwd_kernel": 1e3, "toy_kernel<1>": 2e3, "gemm": 5e3})
    run = types.SimpleNamespace(digest=digest, shapes=shapes, config=config,
                                peaks=SXM, root=video_root)
    hal = registry.find(ROOT, "roofline/kernels", "hal_fwd").bound(
        shapes, config, SXM)
    expect = 100 * (2 * hal + 3 * 1e9 / SXM["bfloat16"]) / 3e-3
    assert readers.kernels_roofline(run) == pytest.approx(expect, rel=1e-12)
    run.root = ROOT  # no toy entry: its kernel is neither bound nor time
    assert readers.kernels_roofline(run) == pytest.approx(
        100 * 2 * hal / 1e-3, rel=1e-12)


@pytest.mark.parametrize("name", sorted(registry.every(ROOT, "loops")))
def test_every_loop_is_calibrated_through_its_own_file(name):
    """``calibrate.py`` asks a loop for its first unit (``first_only``) and
    for a stand-in's numbers (``stand_in``), and never names a loop."""
    loop = registry.find(ROOT, "loops", name)
    assert "first_only" in inspect.signature(loop.run).parameters
    assert list(inspect.signature(loop.stand_in).parameters) == [
        "cell", "seed", "device", "who"]
    with open(os.path.join(ROOT, "portbench", "calibrate.py")) as f:
        assert name not in f.read()


VIDEO = registry.find(ROOT, "reference/nets", "VideoConvNetMean")


def test_the_second_nets_init_is_the_ports():
    from video_distillation_torch.distill.mtt import flat_param_template
    _, theta = flat_param_template("VideoConvNetMean", 3, 3, (16, 16), 8,
                                   torch.Generator().manual_seed(5), CPU)
    ref = VIDEO.init_theta(torch.Generator().manual_seed(5), VIDEO_MODEL, CPU)
    assert torch.equal(theta, ref)
    assert num_params(VIDEO.leaves(dict(VIDEO_MODEL, num_classes=50,
                                        im_size=112, frames=16))) == 709170


def test_the_second_nets_forward_is_the_ports():
    from video_distillation_torch.distill.mtt import flat_param_template
    from video_distillation_torch.distill.params import layout_for
    model, theta = flat_param_template("VideoConvNetMean", 3, 3, (16, 16), 8,
                                       torch.Generator().manual_seed(1), CPU)
    g = torch.Generator().manual_seed(2)
    theta = theta + 0.1 * torch.randn(theta.shape, generator=g)
    x = VIDEO.prepare(torch.randn((2, 8, 64, 64, 3), generator=g), VIDEO_MODEL)
    assert x.shape[2:4] == (16, 16)
    ours = VIDEO.forward(VIDEO.unflatten(theta, VIDEO_MODEL), x, VIDEO_MODEL)
    theirs = functional_call(model, layout_for(model).unflatten(theta), (x,),
                             dict(train=True))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)
    assert VIDEO.keep_mask_shape(VIDEO_MODEL) is None


CONVNET3D = registry.find(ROOT, "reference/nets", "ConvNet3D")
TOY_3D = toy.TOY_CONFIG["model"]


def test_the_moved_convnet3d_is_the_parents():
    """The parent's ``reference/convnet3d.py`` at 3 classes, 64x64x8: its
    init's bytes, and its fp64 logits on clips and a keep-mask drawn from
    seed 11 (to 1e-12, the order of fp64 sums aside)."""
    theta = CONVNET3D.init_theta(torch.Generator().manual_seed(5), TOY_3D, CPU)
    assert hashlib.sha256(theta.numpy().tobytes()).hexdigest() == (
        "4a70f4241edcd1b7fb0dcd937e6a3729b37dd26a7438960abddc33bae1694eee")
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 8, 64, 64, 3), generator=g, dtype=torch.float64)
    keep = torch.rand((2,) + CONVNET3D.keep_mask_shape(TOY_3D),
                      generator=g) < 0.5
    logits = CONVNET3D.forward(CONVNET3D.unflatten(theta.double(), TOY_3D),
                               x, TOY_3D, keep)
    parent = [-0.015935904309967934, -0.00306769611616009,
              -0.09679664112152793, -0.059842106283794196,
              -0.1601822370247709, 0.13418860337983773]
    assert logits.flatten().tolist() == pytest.approx(parent, rel=1e-12)
    assert CONVNET3D.prepare(x, TOY_3D) is x


# bytes a launch at the parent, by family: (hal_fwd, hal_dgrad, phase trio,
# s2d2 mover), at each cell's Shapes
PARENT_BYTES = {
    "ucf_s2d_mtt": (Shapes(500, 50, 16, 112, 112, 2),
                    (840448000, 802816000, 441548800, 267571200)),
    "k400_s2d_mtt": (Shapes(2560, 256, 8, 64, 64, 2),
                     (734003200, 671088640, 369098752, 241434624)),
    "ucf_eval_vmap": (Shapes(150, 150, 16, 112, 112, 4),
                      (504268800, 481689600, 2528870400, 1605427200)),
    "ucf_eval_seq": (Shapes(50, 50, 16, 112, 112, 4),
                     (168089600, 160563200, 842956800, 535142400)),
}
FAMILY = {"hal_fwd": 0, "hal_wgrad": 0, "hal_fused": 0, "hal_dgrad": 1,
          "phase_argmax": 2, "phase_select": 2, "phase_scatter": 2,
          "s2d2_pack": 3, "s2d2_unpack": 3}


@pytest.mark.parametrize("cell", list(PARENT_BYTES))
def test_the_nine_moved_bounds_are_the_parents(cell):
    shapes, parent = PARENT_BYTES[cell]
    config = bench.load_cell(ROOT, cell).config
    entries = registry.every(ROOT, "roofline/kernels")
    assert set(entries) == set(FAMILY) | {"conv3d_s2_fprop"}
    for kernel, fam in FAMILY.items():
        assert entries[kernel].bound(shapes, config, SXM) == (
            parent[fam] / SXM["bytes_per_s"]), kernel


@pytest.mark.parametrize("cell,gflop,ms", [("ucf_s2d_mtt", 377.6, 0.382),
                                          ("k400_s2d_mtt", 315.7, 0.319)])
def test_conv3d_s2_is_bound_by_its_operations(cell, gflop, ms):
    """2·M·128·9,408 FLOP at the bf16 peak, M the second stage's output
    positions; the third stage's GEMM is under the route's 16,384 rows."""
    c = bench.load_cell(ROOT, cell)
    m, d = c.config["model"], c.config["distill"]
    batch = min(d["batch_syn"] or m["num_classes"], m["num_classes"])
    shapes = Shapes(compose=d["syn_steps"] * batch, inner=batch,
                    frames=m["frames"], h=m["im_size"], w=m["im_size"], elem=2)
    s = registry.find(ROOT, "roofline/kernels", "conv3d_s2_fprop").bound(
        shapes, c.config, SXM)
    assert round(s * SXM["bfloat16"] / 1e9, 1) == gflop
    assert round(s * 1e3, 3) == ms
    third = batch * (m["frames"] // 2) * (-(-m["im_size"] // 32)) ** 2
    assert third in (6400, 4096) and third < 16384


# the parent's checks of the toy cells at seed 2**31 + 5 on one CPU thread,
# where the CPU's sums run in one order, to 1e-12 relative (the program's
# or the reference's CPU arithmetic, changed, moves them, and so may a
# PyTorch whose CPU kernels sum in another order)
PARENT_CHECKS = {
    "toy_distill": {"loss_gap": 1.1536357927963982e-07,
                    "grad_gap": 2.3975130146289988e-08,
                    "change_gap": 2.983577432177111e-08,
                    "logit_gap": 1.6545634557187072e-07},
    "toy_eval_vmap": {"net_change_gap": 6.667420501288073e-06,
                      "logit_gap": 6.372787670938324e-07},
    "toy_eval_seq": {"net_change_gap": 7.816840261340051e-08,
                     "logit_gap": 7.008307479002378e-07},
}


@pytest.mark.parametrize("workload", list(PARENT_CHECKS))
def test_the_toy_cells_check_as_at_the_parent(toy_root, workload):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = _run(toy_root, workload, seed=2 ** 31 + 5)
    finally:
        torch.set_num_threads(threads)
    parent = PARENT_CHECKS[workload]
    assert set(line["checks"]) == set(parent)
    for k, c in line["checks"].items():
        assert c["value"] == pytest.approx(parent[k], rel=1e-12, abs=0), k
