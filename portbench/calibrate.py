"""Readings that set the limits of ``correct``, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--stand-ins fp8,int8,half_batch,perturbed]

For each seed, the program's readings: the cell's set-up, its window up to
the first step (or call) it compares, then the comparison with the
reference, as a run of the benchmark makes it. For each control seed, each
stand-in asked for, put in the program's place and compared with the
reference in the same way:

* the control, the reference in the precision below the configuration's:
  for bf16 ``fp8`` (e4m3) or ``int8``, each at a per-tensor scale on every
  convolution's operands and on the gradients of its backward; for fp32
  ``tf32`` (any stand-in named so);
* ``half_batch``: every inner batch's mean taken over its first half;
* ``perturbed``: the fp32 reference on a static memory perturbed by a
  relative 1e-7 (what a rounding of the inputs alone does to each number).

One JSON line each; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness import bench, inputs, loops  # noqa: E402
from portbench.reference import evaluate as ref_eval  # noqa: E402
from portbench.reference import s2d_mtt as ref_mtt  # noqa: E402

PERTURB = 1e-7


def round_fp8(t):
    """t rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to e4m3's 448)."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def round_int8(t):
    """t rounded to int8 at a symmetric per-tensor scale (its largest
    magnitude to 127)."""
    scale = t.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(t / scale).clamp(-127, 127) * scale


class Quant:
    """Every convolution of the reference in a lower precision: operands,
    and the gradients of its backward, rounded by ``fn`` (differentiable to
    any order: each backward is the rounding again)."""

    def __init__(self, fn):
        class Operand(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return fn(t)

            @staticmethod
            def backward(ctx, g):
                return Operand.apply(g)

        class Result(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return t.view_as(t)

            @staticmethod
            def backward(ctx, g):
                return Operand.apply(g)

        self.operand, self.result = Operand.apply, Result.apply


fp8, int8 = Quant(round_fp8), Quant(round_int8)
QUANTS = {"fp8": fp8, "int8": int8}


def _perturbed(state, seed, device):
    g = inputs.generator(seed, 9, device)
    noise = torch.randn(state["static"].shape, generator=g, device=device)
    return dict(state, static=state["static"] * (1 + PERTURB * noise))


def training_stand_in(cell, seed, device, who):
    """A stand-in in the program's place for a training cell: its first
    steps and its compared first forward against the fp32 reference's."""
    conf, tr = cell.config, cell.traffic
    m, d = conf["model"], conf["distill"]
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], m["im_size"], device)
    traj = inputs.trajectories(seed, tr["experts"], tr["snapshots"],
                               loops.DRIFT, m["channel"], m["num_classes"],
                               device)
    st = loops.mtt_setting(conf)
    leaves = ["dynamic", "hal_w", "hal_b"]
    init = {k: state[k].clone() for k in leaves}
    if d["train_lr"]:
        init["syn_lr"] = torch.tensor(float(d["lr_teacher"]), device=device)
    host = {k: v.cpu() for k, v in state.items()}
    quant = QUANTS.get(who)
    start = _perturbed(state, seed, device) if who == "perturbed" else state
    k = loops.logits_step(seed)
    stand = ref_mtt.first_steps(st, seed, dict(start), d["lr_teacher"],
                                [traj], max(3, k), device, quant,
                                who == "half_batch")
    before = dict(start, **{x: stand[k - 1]["state"][x] for x in leaves})
    theta0, _, plan = ref_mtt.step_inputs(st, seed, [traj], k, device)
    logits, _ = ref_mtt.first_logits(st, before, theta0, plan,
                                      ref_mtt.step_generator(seed, k, device),
                                      quant)
    prog = {"losses": [float(r["loss"]) for r in stand[:3]],
            "grads": dict(stand[0]["grads"]),
            "state": dict(stand[2]["state"], syn_lr=stand[2]["syn_lr"]),
            "before": {x: before[x].cpu() for x in leaves},
            "logits": logits}
    del stand, state, start, before
    numbers = loops.reference_training(st, seed, host, init, traj, prog,
                                       d["lr_teacher"], device)
    numbers["logit_gap"] = loops.reference_logits(st, seed, host, traj, prog,
                                                  k, device)
    return numbers


def eval_stand_in(cell, seed, device, who):
    """A stand-in in the program's place for an evaluation cell: one
    call's nets against the fp32 reference's."""
    conf = cell.config
    m, d, e = conf["model"], conf["distill"], conf["eval"]
    state = inputs.s2d_state(seed, m["num_classes"], d["spc"], d["dpc"],
                             m["frames"], m["im_size"], device)
    es = loops.eval_setting(conf)
    k, vmap = loops.WARMUP_CALLS, cell.traffic["vmap"]
    tf32 = who not in ("half_batch", "perturbed")
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    start = _perturbed(state, seed, device) if who == "perturbed" else state
    stand = ref_eval.train_nets(es, start, loops.call_generator(seed, k, device),
                                e["num_eval"], vmap, device,
                                half_batch=who == "half_batch")
    kept = {k: (torch.stack([r["theta"] for r in stand]),
                torch.stack([r["logits0"] for r in stand]))}
    loops._no_tf32()
    return loops.reference_eval(es, seed, state, kept, e["num_eval"], vmap,
                                device, m)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--stand-ins", default="fp8")
    a = p.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = bench.load_cell(bench.ROOT, a.workload)
    training = cell.traffic["loop"] == "distill_s2d"
    # the first step (or call) the window can compare is the one compared
    loops.LOGITS_AMONG, loops.CHECK_CALLS, loops.CHECK_AMONG = 1, 1, 1
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    stand_ins = [w for w in a.stand_ins.split(",") if w]
    for seed in seeds:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as scratch:
            run = loops.LOOPS[cell.traffic["loop"]](
                cell, bench.program_seed(seed), 0.0, False, device, scratch, t)
        print(json.dumps({"workload": a.workload, "who": "program",
                          "seed": seed, "numbers": run.numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in controls:
        for who in stand_ins:
            t = time.perf_counter()
            s = bench.program_seed(seed)
            numbers = (training_stand_in if training else eval_stand_in)(
                cell, s, device, who)
            print(json.dumps({"workload": a.workload, "who": who,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
