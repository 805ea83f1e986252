"""How far one small raw MTT step strays between the card and the CPU, seed
by seed, with the fused first stage and with the plain one.

    python3 scripts/mtt_card_vs_cpu.py [--seeds 9]

Runs the raw MTT comparison of ``chip_smoke.py``'s ``baselines`` phase
(``mtt_card_vs_cpu``: syn_steps=2, 3 classes, 64x64x8, fp32 on the card and
on the CPU and fp64 on the CPU, from the same inputs, plan and dropout
masks) for each seed of the synthetic images and masks, first with
ConvNet3D's fused first stage (the default) and then with
``fuse_first_stage=False``. Seed 0 draws what ``chip_smoke.py`` checks.
Prints one JSON line a run: the relative distances of the loss and the
outer gradients, card against CPU and each fp32 device against fp64.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=9)
    args = ap.parse_args(argv)
    chip_smoke.use_exact_fp32()
    c = chip_smoke.BASELINES_SMALL
    nc, f, im = c["num_classes"], c["frames"], c["im_size"][0]
    fused_step = chip_smoke.MTTStep

    class PlainStageStep(fused_step):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.core.model.fuse_first_stage = False

    try:
        for fused in (True, False):
            chip_smoke.MTTStep = fused_step if fused else PlainStageStep
            for seed in range(args.seeds):
                # the draws of check_baselines_card_vs_cpu: the images, the
                # S2D-DM step's slot draws, then the masks
                gen = torch.Generator().manual_seed(seed)
                syn = torch.randn(nc, f, im, im, 3, generator=gen)
                torch.randint(0, 2, (2, nc), generator=gen)
                print(json.dumps({"fused": fused, "seed": seed,
                                  **chip_smoke.mtt_card_vs_cpu(syn, gen)}),
                      flush=True)
    finally:
        chip_smoke.MTTStep = fused_step


if __name__ == "__main__":
    main()
