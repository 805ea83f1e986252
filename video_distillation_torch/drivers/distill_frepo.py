"""FRePo S2D distillation driver.

Port of ``video_distillation_tpu/drivers/distill_frepo.py`` (the
reference's ``FRePo/script/distill_s2d.py``)::

    python -m video_distillation_torch.drivers.distill_frepo \\
        --dataset miniUCF101 --data_path data [--device cuda]

The same flags as the JAX driver, plus ``--device``: the run is on CUDA
unless ``--device cpu`` is given. Every ``eval_it`` iterations the
prototypes are composed once (``compose_eval``) and evaluated twice:
KRR against a random pool net (``KRR_Accuracy``), then ``num_eval`` fresh
nets per eval-pool model trained under FRePo's protocol (AdamW, MSE on the
soft labels, no batch standardisation, the debiased parameter EMA;
``Accuracy/<model>``, ``Std/<model>``, ``Max_Accuracy/<model>``). A new best
of ``--model`` writes ``x_proto_best.npy``, ``state_best.npz`` (the JAX
layout) and a PNG grid under ``<save_path>/FRePo_<dataset>/``. A checkpoint
every ``ckpt_it`` iterations holds the synthetic state, its optimizer, the
whole pool, the best accuracies and the host RNG, so a run resumes
exactly.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DistillConfig
from ..distill.evaluate import EvalConfig, evaluate_many
from ..distill.frepo import FRePoConfig, FRePoTrainer, krr_evaluate
from ..distill.params import hal_to_jax
from ..models.registry import get_eval_pool
from ..parallel import init_distributed
from ..utils.checkpoint import (restore_state, save_artifact,
                                save_pytree_artifact, save_state)
from ..utils.device import resolve_device, step_generator, use_exact_fp32
from ..utils.logging import MetricLogger, StepTimer
from ..utils.visualize import save_video_grid
from .common import EVAL_STREAM, INIT_STREAM, load_data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FRePo S2D distillation")
    p.add_argument("--dataset", default="miniUCF101")
    p.add_argument("--model", default="ConvNet3D")
    p.add_argument("--num_prototypes_per_class", type=int, default=1)
    p.add_argument("--dpc", type=int, default=1)
    p.add_argument("--n_hal", type=int, default=1)
    p.add_argument("--lr_d", type=float, default=1e2)
    p.add_argument("--lr_h", type=float, default=1e-3)
    p.add_argument("--lr_net", type=float, default=3e-4)
    p.add_argument("--num_nn_state", type=int, default=10)
    p.add_argument("--max_online_updates", type=int, default=100)
    p.add_argument("--Iteration", type=int, default=10000)
    p.add_argument("--eval_it", type=int, default=2000)
    p.add_argument("--ckpt_it", type=int, default=1000)
    p.add_argument("--num_eval", type=int, default=3)
    p.add_argument("--epoch_eval_train", type=int, default=500)
    p.add_argument("--batch_train", type=int, default=256)
    p.add_argument("--eval_ema_decay", type=float, default=0.995)
    p.add_argument("--learn_label", action="store_true")
    p.add_argument("--eval_mode", default="S",
                   help="eval pool selector; each pool model is evaluated "
                        "per eval step")
    p.add_argument("--shard_store", action="store_true",
                   help="row-shard the uint8 clip store over the ranks")
    p.add_argument("--data_path", default="data")
    p.add_argument("--save_path", default="./logged_files")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--path_static", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _state_jax_layout(state):
    return {k: ([hal_to_jax(h) for h in v] if k == "hals" else v)
            for k, v in state.items()}


def main(argv=None, logger: Optional[MetricLogger] = None,
         step_hook: Optional[Callable] = None):
    """Parse the flags, load the data and distil. Returns ``{'trainer',
    'np_rng', 'best_acc'}``. ``step_hook(it, metrics)``, if given, is called
    at the end of every iteration, after its evaluation and checkpoint."""
    args = parse_args(argv)
    init_distributed(args.device)
    device = resolve_device(args.device)
    use_exact_fp32()
    dcfg = DistillConfig(dataset=args.dataset, data_path=args.data_path,
                         frames=args.frames)
    data = load_data(dcfg)
    meta = data.meta
    cfg = FRePoConfig(num_classes=meta.num_classes,
                      ppc=args.num_prototypes_per_class, dpc=args.dpc,
                      frames=dcfg.frames, im_size=tuple(meta.im_size),
                      n_hal=args.n_hal, lr_d=args.lr_d, lr_h=args.lr_h,
                      lr_net=args.lr_net, num_nn_state=args.num_nn_state,
                      max_online_updates=args.max_online_updates,
                      Iteration=args.Iteration, learn_label=args.learn_label)
    static = np.load(args.path_static) if args.path_static else None
    trainer = FRePoTrainer(data.train, args.model, cfg,
                           step_generator(args.seed, INIT_STREAM, device),
                           static, device, shard_store=args.shard_store)

    save_dir = os.path.join(args.save_path, f"FRePo_{args.dataset}")
    ckpt_dir = os.path.join(save_dir, "ckpt")
    own_logger = logger is None
    if own_logger:
        logger = MetricLogger(log_dir=args.save_path,
                              run_name=f"frepo_{args.dataset}")
    np_rng = np.random.default_rng(args.seed)
    test_rng = np.random.default_rng(args.seed + 123)
    timer = StepTimer()
    eval_pool = get_eval_pool(args.eval_mode, args.model)
    best_acc = {m: 0.0 for m in eval_pool}
    start_it = 1
    restored = restore_state(ckpt_dir, device=device)
    if restored is not None:
        st, last_it, rng_state = restored
        trainer.load_state_dict(st["trainer"])
        best_acc = dict(zip(eval_pool, st["best_acc"].tolist()))
        if rng_state:
            np_rng.bit_generator.state = rng_state
        start_it = last_it + 1
        print(f"resumed FRePo run at iteration {start_it}")

    def evaluate(it):
        gen = step_generator(args.seed, EVAL_STREAM + it, device)
        x_syn = trainer.compose_eval(gen)
        y_syn = trainer.state["y_syn"]
        # KRR accuracy against a random pool net's features
        pool = trainer.pool
        krr_acc = krr_evaluate(
            trainer.model, pool.params(pool.sample_idx(np_rng)), x_syn, y_syn,
            data.test.sample_clips(test_rng, flip=meta.frames > 1),
            data.test.labels, meta.mean, meta.std, reg=cfg.reg)
        scalars = {"KRR_Accuracy": krr_acc}
        for model_eval in eval_pool:
            ecfg = EvalConfig(model=model_eval,
                              epoch_eval_train=args.epoch_eval_train,
                              lr_net=args.lr_net, batch_train=args.batch_train,
                              optimizer="adamw", loss="mse",
                              standardize=False, test_repeats=1,
                              ema_decay=args.eval_ema_decay)
            _, mean, std = evaluate_many(gen, args.num_eval, x_syn, y_syn,
                                         data, ecfg, test_rng)
            if mean > best_acc[model_eval]:
                best_acc[model_eval] = mean
                if model_eval == args.model:
                    save_artifact(save_dir, "x_proto_best", x_syn)
                    save_pytree_artifact(save_dir, "state_best",
                                         _state_jax_layout(trainer.state))
                    save_video_grid(os.path.join(
                        save_dir, "png", f"proto_{str(it).zfill(6)}.png"),
                        x_syn.cpu().numpy(), meta.mean, meta.std)
            scalars[f"Accuracy/{model_eval}"] = mean
            scalars[f"Std/{model_eval}"] = std
            scalars[f"Max_Accuracy/{model_eval}"] = best_acc[model_eval]
        logger.log(scalars, step=it)

    for it in range(start_it, cfg.Iteration + 1):
        metrics = trainer.step(step_generator(args.seed, it, device), np_rng)
        timer.tick()
        if it % 100 == 0:
            metrics["steps_per_sec"] = timer.rate()
            logger.log(metrics, step=it)
        if it % args.eval_it == 0:
            evaluate(it)
        if it % args.ckpt_it == 0:
            save_state(ckpt_dir, {
                "trainer": trainer.state_dict(),
                "best_acc": torch.tensor([best_acc[m] for m in eval_pool],
                                         dtype=torch.float64)}, it, np_rng)
        if step_hook is not None:
            step_hook(it, metrics)
    if own_logger:
        logger.finish()
    return {"trainer": trainer, "np_rng": np_rng, "best_acc": best_acc}


if __name__ == "__main__":
    main()
