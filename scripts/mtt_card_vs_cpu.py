"""How far one small raw MTT step strays between the card and the CPU, draw
by draw, with the fused first stage and with the plain one, and which of
its phase maxes had near ties.

    python3 scripts/mtt_card_vs_cpu.py [--seeds 9]

Runs the raw MTT comparison of ``chip_smoke.py``'s ``baselines`` phase
(``mtt_card_vs_cpu``: syn_steps=2, 3 classes, 64x64x8, fp32 on the card and
on the CPU and fp64 on the CPU, from the same inputs, plan and dropout
masks) for each draw (``mtt_draw``: draw 0 is what ``chip_smoke.py``'s DM
checks use), first with ConvNet3D's fused first stage (the default) and
then with ``fuse_first_stage=False``. Prints one JSON line a run: the
relative distances of the loss and the outer gradients, card against CPU
and each fp32 device against fp64; per run (``routing``), the phase-max
windows whose winner is within 1, 4, 16, 64 and 256 fp32 ulps of its
runner-up and the smallest such margin, and the routing decisions that
differ from the fp64 run's (phase-max winners, later max-pool argmaxes,
activation signs); and whether the draw passes ``check_mtt_draw``
(ROADMAP C.13). With the plain stage no phase max runs: its first
max-pool is counted with the later ones. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=chip_smoke.MTT_DRAWS)
    args = ap.parse_args(argv)
    chip_smoke.use_exact_fp32()
    fused_step = chip_smoke.MTTStep

    class PlainStageStep(fused_step):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.core.model.fuse_first_stage = False

    try:
        for fused in (True, False):
            chip_smoke.MTTStep = fused_step if fused else PlainStageStep
            for seed in range(args.seeds):
                m = chip_smoke.mtt_card_vs_cpu(*chip_smoke.mtt_draw(seed))
                try:
                    chip_smoke.check_mtt_draw(m)
                    m["passes_c13_rule"] = True
                except AssertionError:
                    m["passes_c13_rule"] = False
                print(json.dumps({"fused": fused, "seed": seed, **m}),
                      flush=True)
    finally:
        chip_smoke.MTTStep = fused_step


if __name__ == "__main__":
    main()
