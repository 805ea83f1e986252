"""The lower-precision control of ``correct``. At the toy size on the CPU,
where the program agrees with the reference to rounding, the fp8 control
put in the program's place departs from it a thousandfold more; a program
whose convolutions run one precision step down (fp8 for the bf16 cells,
TF32 for the fp32 ones) comes out not correct through a run, on
``logit_gap``; on the card, the evaluation's TF32 control departs from the
fp32 program. At the cells' own sizes the readings that set the limits
come from ``portbench/calibrate.py`` on the card (PERF.md), through each
loop's ``stand_in``."""

import time

import pytest
import torch
import torch.nn.functional as F

from portbench.harness import bench, stand_ins

SEED = 2 ** 31 + 21


def _program(root, workload, device):
    import tempfile
    cell = bench.load_cell(root, workload)
    with tempfile.TemporaryDirectory() as scratch:
        return bench.loop(root, cell.traffic["loop"]).run(
            cell, SEED, 0.0, False, device, scratch, time.perf_counter()).numbers


def test_the_training_control_departs(toy_root):
    cpu = torch.device("cpu")
    program = _program(toy_root, "toy_distill", cpu)
    cell = bench.load_cell(toy_root, "toy_distill")
    control = bench.loop(toy_root, "distill_s2d").stand_in(cell, SEED, cpu,
                                                           "fp8")
    for k in ("loss_gap", "grad_gap", "change_gap", "logit_gap"):
        assert control[k] > 1000 * max(program[k], 1e-9), (k, program, control)


def round_tf32(t):
    """t rounded to TF32's 10 mantissa bits (straight through)."""
    bits = t.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return t + (bits.view(torch.float32).to(t.dtype) - t).detach()


class _LowConv:
    """``torch.nn.functional`` with the convolutions' operands rounded."""

    def __init__(self, fn):
        self.fn = fn

    def __getattr__(self, name):
        return getattr(F, name)

    def conv2d(self, x, w, *a, **k):
        return F.conv2d(self.fn(x), self.fn(w), *a, **k)

    def conv3d(self, x, w, *a, **k):
        return F.conv3d(self.fn(x), self.fn(w), *a, **k)


@pytest.mark.parametrize("workload,fn", [
    ("toy_distill", stand_ins.round_fp8),
    ("toy_eval_vmap", round_tf32), ("toy_eval_seq", round_tf32)])
def test_a_program_a_precision_step_down_is_not_correct(toy_root, monkeypatch,
                                                        workload, fn):
    from video_distillation_torch.models import convnet3d, layers
    for mod in (convnet3d, layers):
        monkeypatch.setattr(mod, "F", _LowConv(fn))
    args = bench.parse(["--workload", workload, "--seed", str(SEED),
                        "--seconds", "0.2", "--trace", "0"])
    rc, line = bench.run_cell(toy_root, args, time.perf_counter(),
                              device=torch.device("cpu"))
    assert rc == 0 and not line["correct"]
    gap = line["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"], line["checks"]


@pytest.mark.cuda
def test_the_evaluation_control_departs(toy_root, card):
    program = _program(toy_root, "toy_eval_seq", card)
    cell = bench.load_cell(toy_root, "toy_eval_seq")
    control = bench.loop(toy_root, "eval_train").stand_in(cell, SEED, card,
                                                          "tf32")
    assert control["logit_gap"] > 100 * program["logit_gap"], (program, control)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    args = bench.parse(["--workload", "ucf_eval_seq", "--seed", str(SEED),
                        "--seconds", "3", "--trace", "1"])
    rc, line = bench.run_cell(bench.ROOT, args, time.perf_counter())
    assert rc == 0 and line["correct"], line
    assert line["device"]["busy_s"] > 0 and "breakdown" in line
    assert set(line["metrics"]) == {"step.mfu.eval", "net.conv_ms.eval",
                                    "kernels_roofline.eval", "device.idle.eval"}
