"""Readings that set the limits of ``correct``, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--stand-ins fp8,int8,half_batch,perturbed]

For each seed, the program's readings: the cell's set-up, its window up to
the first step (or call) it compares, then the comparison with the
reference, as a run of the benchmark makes it (the loop's ``run`` with
``first_only``). For each control seed, each stand-in asked for, put in
the program's place by the loop's ``stand_in`` and compared with the
reference in the same way: the control, the reference one precision step
down (``fp8``, ``int8``, ``tf32``), or a fault (``half_batch``,
``perturbed``), as ``portbench/harness/stand_ins.py`` sets out.

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

from portbench.harness import bench  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--stand-ins", default="fp8")
    a = p.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = bench.load_cell(bench.ROOT, a.workload)
    loop = bench.loop(cell.root, cell.traffic["loop"])
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    stand_ins = [w for w in a.stand_ins.split(",") if w]
    for seed in seeds:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as scratch:
            run = loop.run(cell, bench.program_seed(seed), 0.0, False,
                           device, scratch, t, first_only=True)
        print(json.dumps({"workload": a.workload, "who": "program",
                          "seed": seed, "numbers": run.numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in controls:
        for who in stand_ins:
            t = time.perf_counter()
            numbers = loop.stand_in(cell, bench.program_seed(seed), device,
                                    who)
            print(json.dumps({"workload": a.workload, "who": who,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
