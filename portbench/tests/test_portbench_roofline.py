"""The counts that do not move with the program: the kernels' bound
times at the slice's shapes, each configuration's FLOPs, the peaks."""

import json
import os

import pytest

from portbench.harness import registry
from portbench.roofline import flops
from portbench.roofline.peaks import card_peaks
from portbench.roofline.shapes import Shapes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SXM = card_peaks("NVIDIA H100 80GB HBM3")
# the slice: 500 clips composed, 50 a first-stage launch, 16 x 112 x 112, bf16
SLICE = Shapes(compose=500, inner=50, frames=16, h=112, w=112, elem=2)
# the evaluation's fp32 composition of 50 clips
EVAL = Shapes(compose=50, inner=50, frames=16, h=112, w=112, elem=4)


@pytest.mark.parametrize("kernel,shapes,ms", [
    ("hal_fwd", SLICE, 0.2509), ("hal_dgrad", SLICE, 0.2396),
    ("hal_wgrad", SLICE, 0.2509), ("hal_fused", EVAL, 0.0502),
    ("phase_argmax", SLICE, 0.1318), ("phase_select", SLICE, 0.1318),
    ("phase_scatter", SLICE, 0.1318), ("s2d2_pack", SLICE, 0.0799),
    ("s2d2_unpack", SLICE, 0.0799), ("s2d2_pack", EVAL, 0.1597),
    ("conv3d_s2_fprop", SLICE, 0.3818)])
def test_bound_ms_matches_the_kernel_table(kernel, shapes, ms):
    entry = registry.find(ROOT, "roofline/kernels", kernel)
    config = _config("convnet3d_ucf50_s2d_ipc1")
    assert round(entry.bound(shapes, config, SXM) * 1e3, 4) == ms


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _net(c):
    return registry.find(ROOT, "reference/nets", c["model"]["name"])


@pytest.mark.parametrize("name", ["convnet3d_ucf50_s2d_ipc1",
                                  "convnet3d_k400_s2d_ipc1"])
def test_stored_flops_are_the_references(name):
    c = _config(name)
    m, d = c["model"], c["distill"]
    n_syn = m["num_classes"] * d["vpc"]
    batch = min(d["batch_syn"] or n_syn, n_syn)
    assert c["flops"]["outer_step"] == flops.outer_step_flops(
        _net(c), m, d["syn_steps"], batch)
    if "eval_net_step" in c["flops"]:
        e = c["eval"]
        assert c["flops"]["eval_net_step"] == flops.eval_step_flops(
            _net(c), m, min(e["batch_train"], n_syn))


def test_flops_follow_the_forward_count():
    """An evaluation step is about three forward passes' worth of products
    (forward, input and weight gradients, less the first conv's input
    gradient): ConvNet3D's forward is 11.0 GFLOP a 112x112x16 clip."""
    c = _config("convnet3d_ucf50_s2d_ipc1")
    step = flops.eval_step_flops(_net(c), c["model"], 1)
    assert 2.5 * 11.0e9 < step < 3.0 * 11.0e9


@pytest.mark.parametrize("name,bw,bf16", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 989e12),
    ("NVIDIA H100 PCIe", 2.0e12, 756e12),
    ("NVIDIA H100 NVL", 3.9e12, 835e12)])
def test_peaks_by_part(name, bw, bf16):
    p = card_peaks(name)
    assert (p["bytes_per_s"], p["bfloat16"]) == (bw, bf16)
