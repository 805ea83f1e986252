"""The plain reference against the port's CPU path at a small size: the
same init from the same generator, the same forward, the same composition,
and the first steps of a run and an evaluation call from the same draws."""

import time

import pytest
import torch
from torch.func import functional_call

from portbench.harness import bench, inputs, registry
from portbench.reference.hallucinator import hallucinate

CPU = torch.device("cpu")
NET = registry.find(bench.ROOT, "reference/nets", "ConvNet3D")


def _model(num_classes=3, im=64, frames=8):
    """The configuration's ``model`` of a ConvNet3D at these sizes."""
    return {"name": "ConvNet3D", "channel": 3, "num_classes": num_classes,
            "im_size": im, "frames": frames, "first_width": 64,
            "net_width": 128, "net_depth": 3, "kernel": [3, 7, 7],
            "dropout": 0.5}


def _port_net(num_classes=3, im=64, frames=8, generator=None):
    from video_distillation_torch.distill.mtt import flat_param_template
    return flat_param_template("ConvNet3D", 3, num_classes, (im, im), frames,
                               generator, CPU)


def test_init_is_the_ports():
    _, theta = _port_net(generator=torch.Generator().manual_seed(5))
    ref = NET.init_theta(torch.Generator().manual_seed(5), _model(), CPU)
    assert torch.equal(theta, ref)


@pytest.mark.parametrize("im,frames", [(64, 8), (112, 16)])
def test_forward_is_the_ports(im, frames):
    from video_distillation_torch.distill.params import layout_for
    model, theta = _port_net(4, im, frames, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, frames, im, im, 3), generator=g)
    m = _model(4, im, frames)
    c, t, h, w = NET.keep_mask_shape(m)
    keep = torch.rand((2, c, t, h, w), generator=g) < 0.5
    ours = NET.forward(NET.unflatten(theta, m), x, m, keep)
    theirs = functional_call(model, layout_for(model).unflatten(theta), (x,),
                             dict(train=True, keep_mask=keep.permute(0, 2, 3, 4, 1)))
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_hallucinate_is_the_ports():
    from video_distillation_torch.models.hallucinator import hal_apply
    st = inputs.s2d_state(3, 2, 2, 2, 4, 8, CPU)
    static, dynamic = st["static"][:2], st["dynamic"][:, 0]
    ours = hallucinate(st["hal_w"], st["hal_b"], static, dynamic)
    theirs = hal_apply({"weight": st["hal_w"], "bias": st["hal_b"]}, static,
                       dynamic)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def _numbers(root, workload, seed):
    cell = bench.load_cell(root, workload)
    import tempfile
    with tempfile.TemporaryDirectory() as scratch:
        run = bench.loop(root, cell.traffic["loop"]).run(
            cell, seed, 0.0, False, CPU, scratch, time.perf_counter())
    return run.numbers


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_first_steps_of_a_run_are_the_ports(toy_root, seed):
    n = _numbers(toy_root, "toy_distill", seed)
    assert n["loss_gap"] < 1e-6
    assert n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-5
    assert n["logit_gap"] < 1e-5


@pytest.mark.parametrize("workload", ["toy_eval_vmap", "toy_eval_seq"])
def test_an_evaluation_call_is_the_ports(toy_root, workload):
    n = _numbers(toy_root, workload, 2 ** 31 + 12)
    assert n["net_change_gap"] < 1e-4 and n["logit_gap"] < 1e-5
