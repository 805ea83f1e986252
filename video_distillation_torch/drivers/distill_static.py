"""Static-memory learning driver: DC gradient matching on single-frame
datasets.

Port of ``video_distillation_tpu/drivers/distill_static.py``. The reference
delegates this step to the external DC repo, providing only the
``single*`` dataset loaders (its ``README.md`` "Static Learning";
``distill_utils/dataset.py:18-77,897-946``). Here it learns ``spc`` static
images per class with DC on a single-frame store and writes
``static_<dataset>_spc<spc>.npy``, ``(C*spc, H, W, 3)`` fp32, which S2D
reads through ``--path_static``::

    python -m video_distillation_torch.drivers.distill_static \\
        --dataset miniUCF101 --data_path data --spc 10 [--device cuda]

``get_loops`` has rows for spc 1, 5, 10, 20, 30, 40 and 50 only, so the
default ``--spc 2`` (the JAX driver's) raises. Under ``torchrun`` every
rank learns the whole static memory (the JAX driver takes no mesh: more
ranks gain nothing) and rank 0 writes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..config import DistillConfig
from ..data.store import ClipStore
from ..distill.dc import make_dc_trainer
from ..distill.dm import init_synthetic_raw
from ..parallel import init_distributed
from ..utils.checkpoint import save_artifact
from ..utils.device import resolve_device, step_generator, use_exact_fp32
from ..utils.logging import MetricLogger
from .common import load_data


def to_single_frame_store(store: ClipStore,
                          rng: np.random.Generator) -> ClipStore:
    """Derive a single-frame (image) store from a video clip store — the
    reference's single* datasets return one random frame per clip
    (dataset.py:69-77)."""
    n, f = store.clips.shape[:2]
    pick = rng.integers(0, f, size=n)
    frames = store.clips[np.arange(n), pick]
    meta = dataclasses.replace(store.meta, name=f"single_{store.meta.name}",
                               frames=1)
    return ClipStore(frames, store.labels.copy(), meta)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DC static-memory learning")
    p.add_argument("--dataset", default="miniUCF101")
    p.add_argument("--model", default="ConvNet")
    p.add_argument("--spc", type=int, default=2,
                   help="static images per class to learn")
    p.add_argument("--lr_img", type=float, default=0.1)
    p.add_argument("--lr_net", type=float, default=0.01)
    p.add_argument("--batch_real", type=int, default=64)
    p.add_argument("--Iteration", type=int, default=1000)
    p.add_argument("--dis_metric", default="ours")
    p.add_argument("--data_path", default="data")
    p.add_argument("--save_path", default="./logged_files/static")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None, logger=None) -> str:
    """Learn the static memory; returns the path of the ``.npy`` written.
    Iterations 0 to ``--Iteration`` run, as in the JAX driver; the loss
    is logged every 100."""
    args = parse_args(argv)
    init_distributed(args.device)
    device = resolve_device(args.device)
    use_exact_fp32()
    data = load_data(DistillConfig(dataset=args.dataset,
                                   data_path=args.data_path))
    rng = np.random.default_rng(args.seed)
    singles = to_single_frame_store(data.train, rng)
    syn, labels = init_synthetic_raw(None, singles, args.spc, 1, "real", rng,
                                     device)
    syn = syn.reshape((syn.shape[0],) + syn.shape[2:])  # drop frame dim
    mom = torch.zeros_like(syn)

    trainer = make_dc_trainer(singles, args.model, args.spc, args.batch_real,
                              args.lr_img, args.lr_net, args.dis_metric,
                              device)
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(run_name=f"static_{args.dataset}")
    for it in range(args.Iteration + 1):
        syn, mom, loss = trainer(step_generator(args.seed, it, device), syn,
                                 labels, mom, rng)
        if it % 100 == 0:
            logger.log({"Loss": loss}, step=it)
    name = f"static_{args.dataset}_spc{args.spc}"
    save_artifact(args.save_path, name, syn)
    if own_logger:
        logger.finish()
    print(f"static memory saved to {args.save_path}")
    return os.path.join(args.save_path, f"{name}.npy")


if __name__ == "__main__":
    main()
