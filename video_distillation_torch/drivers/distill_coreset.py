"""Coreset baseline driver: k-center or herding selection, then evaluation.

Port of ``video_distillation_tpu/drivers/distill_coreset.py`` (the
reference's ``distill_coreset.py``)::

    python -m video_distillation_torch.drivers.distill_coreset \\
        --dataset miniUCF101 --method herding --ipc 1 [--device cuda]

The run is on CUDA unless ``--device cpu`` is given. ``ipc`` clips per
class are chosen in the embedding space of a frozen random net drawn from
``--seed``, then ``num_eval`` fresh nets of each model of the
``--eval_mode`` pool are trained on them at ``--lr_net`` and tested;
accuracy and its spread are logged per model.

Under ``torchrun`` every rank selects the whole coreset (the JAX driver
takes no mesh for it, so more ranks gain nothing there) and takes rank
0's; the evaluation is split over the ranks as every evaluation is; rank 0
logs.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..config import DistillConfig
from ..distill.coreset import SELECTORS, select_coreset
from ..distill.evaluate import EvalConfig, evaluate_many
from ..models.registry import get_eval_pool
from ..parallel import broadcast_tensors_, init_distributed
from ..utils.device import resolve_device, step_generator, use_exact_fp32
from ..utils.logging import MetricLogger
from .common import EVAL_STREAM, load_data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Coreset baselines")
    p.add_argument("--dataset", default="miniUCF101")
    p.add_argument("--method", default="k-center", choices=sorted(SELECTORS))
    p.add_argument("--model", default="ConvNet3D")
    p.add_argument("--ipc", type=int, default=1)
    p.add_argument("--eval_mode", default="S")
    p.add_argument("--num_eval", type=int, default=5)
    p.add_argument("--epoch_eval_train", type=int, default=1000)
    p.add_argument("--lr_net", type=float, default=0.001)
    p.add_argument("--batch_train", type=int, default=256)
    p.add_argument("--data_path", default="data")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None, logger: Optional[MetricLogger] = None):
    """Select the coreset and evaluate it; returns (syn_images, labels,
    {model: (mean accuracy, std)})."""
    args = parse_args(argv)
    init_distributed(args.device)
    device = resolve_device(args.device)
    use_exact_fp32()
    cfg = DistillConfig(dataset=args.dataset, model=args.model, ipc=args.ipc,
                        data_path=args.data_path, frames=args.frames,
                        seed=args.seed)
    data = load_data(cfg)
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(run_name=f"coreset_{args.method}_{args.dataset}")
    syn, labels = select_coreset(step_generator(args.seed, 0, device),
                                 data.train, args.model, args.ipc,
                                 args.method, cfg.frames, device=device)
    broadcast_tensors_([syn])  # one coreset on every rank
    test_rng = np.random.default_rng(args.seed + 123)
    gen = step_generator(args.seed, EVAL_STREAM, device)
    accs = {}
    for model_eval in get_eval_pool(args.eval_mode, args.model):
        ecfg = EvalConfig(model=model_eval,
                          epoch_eval_train=args.epoch_eval_train,
                          lr_net=args.lr_net, batch_train=args.batch_train,
                          eval_mode=args.eval_mode)
        _, mean, std = evaluate_many(gen, args.num_eval, syn, labels, data,
                                     ecfg, test_rng)
        accs[model_eval] = (mean, std)
        logger.log({f"Accuracy/{model_eval}": mean, f"Std/{model_eval}": std})
    if own_logger:
        logger.finish()
    return syn, labels, accs


if __name__ == "__main__":
    main()
