"""Offline packing driver: reference frame-dir layouts -> packed stores.

Port of ``video_distillation_tpu/drivers/pack.py``. Replaces the online PIL
loaders; run once per dataset (PIL needed):

    python -m video_distillation_torch.drivers.pack \
        --dataset miniUCF101 --data_path distill_utils/data --out packed/
"""

from __future__ import annotations

import argparse

from ..data.packer import pack_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description="Pack a dataset")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out = pack_dataset(args.dataset, args.data_path, args.out, args.seed)
    print(f"packed -> {out}")


if __name__ == "__main__":
    main()
