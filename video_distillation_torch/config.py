"""Typed experiment configuration + named presets.

A copy of ``video_distillation_tpu/config.py`` (the port imports nothing of
the JAX package), plus the ``device`` field the port's drivers read.

Replaces the reference's per-driver argparse + frozen ``sh/`` scripts
(the reference's ``sh/``, ``distill_baseline.py:366-417``,
``distill_s2d_ms.py:451-506``, ``buffer.py:107-128``) with one shared
dataclass schema. Each preset encodes the exact hyperparameters of the
corresponding launch script.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DistillConfig:
    # experiment
    dataset: str = "miniUCF101"
    method: str = "DM"              # DM | MTT | FRePo
    model: str = "ConvNet3D"
    data_path: str = "data"
    packed_path: Optional[str] = None  # dir of packed stores
    save_path: str = "./logged_files"
    buffer_path: Optional[str] = None
    seed: int = 0

    # synthetic set (raw parameterization)
    ipc: int = 1
    init: str = "real"              # real | noise
    frames: int = 16

    # S2D parameterization
    s2d: bool = False
    spc: int = 2
    dpc: int = 2
    vpc: int = 1
    n_hal: int = 1
    no_train_static: bool = True
    path_static: Optional[str] = None
    lr_static: float = 100.0
    lr_dynamic: float = 0.01
    lr_hal: float = 0.01

    # optimisation
    Iteration: int = 5000
    lr_img: float = 1.0
    lr_net: float = 0.01
    lr_teacher: float = 0.01        # init value of the (learnable) syn lr
    lr_lr: float = 1e-5
    train_lr: bool = False
    batch_real: int = 64
    batch_train: int = 256
    batch_syn: Optional[int] = None

    # MTT
    expert_epochs: int = 1
    syn_steps: int = 10
    max_start_epoch: int = 10

    # evaluation
    eval_mode: str = "SS"
    num_eval: int = 5
    eval_it: int = 500
    epoch_eval_train: int = 500
    startIt: int = 0
    # train all num_eval nets in ONE vmapped scan (identical per-net
    # semantics, ~num_eval x eval throughput on TPU)
    vmap_eval: bool = True

    # execution
    device: str = "cuda"                 # 'cpu' only when asked for
    mesh_shape: Tuple[int, ...] = (1,)   # data-parallel devices
    compute_dtype: str = "float32"       # 'bfloat16' to run convs in bf16
    # MTT outer-backward mode: 'rof' (custom-VJP reverse-over-forward,
    # fastest), 'remat' (checkpointed reverse-over-reverse), 'full'
    # (no remat; highest memory)
    second_order: str = "rof"
    # row-shard the uint8 clip store over the mesh (1/n_dev HBM per chip)
    # for K400/SSv2-scale datasets that exceed one chip
    shard_store: bool = False

    def resolved_batch_syn(self, num_classes: int) -> int:
        n = num_classes * (self.vpc if self.s2d else self.ipc)
        return min(self.batch_syn or n, n)


@dataclasses.dataclass
class BufferConfig:
    """Expert-trajectory generation (sh/baseline/buffer.sh, buffer.py)."""
    dataset: str = "miniUCF101"
    model: str = "ConvNet3D"
    data_path: str = "data"
    packed_path: Optional[str] = None
    buffer_path: str = "./buffers"
    num_experts: int = 30
    train_epochs: int = 50
    lr_teacher: float = 0.01
    batch_train: int = 256
    mom: float = 0.0
    l2: float = 0.0
    decay: bool = False
    save_interval: int = 10
    eval_mode: str = "SS"
    frames: int = 16
    seed: int = 0
    # bf16 conv compute with fp32 master weights — ~4x the fp32 epoch
    # throughput; snapshots stay fp32 (see PARITY.md)
    compute_dtype: str = "bfloat16"
    # row-shard the uint8 clip store over the mesh (K400-scale corpora)
    shard_store: bool = False


_PRESETS = {
    # sh/baseline/DM.sh
    "DM": DistillConfig(method="DM", num_eval=5, epoch_eval_train=500,
                        init="real", lr_net=0.01, Iteration=5000,
                        eval_mode="SS", eval_it=500, batch_real=64),
    # sh/baseline/MTT.sh
    "MTT": DistillConfig(method="MTT", num_eval=3, epoch_eval_train=500,
                         init="real", syn_steps=10, expert_epochs=1,
                         max_start_epoch=10, lr_teacher=0.01,
                         Iteration=8000, eval_mode="SS", eval_it=400,
                         train_lr=True),
    # sh/s2d/s2d_DM_ms.sh (ipc=1)
    "s2d_DM_ms": DistillConfig(method="DM", s2d=True, num_eval=3, vpc=1,
                               spc=2, dpc=2, epoch_eval_train=500,
                               batch_real=64, Iteration=5000, eval_mode="SS",
                               eval_it=400, no_train_static=True,
                               startIt=400),
    # sh/s2d/s2d_DM_ms_5.sh (ipc=5)
    "s2d_DM_ms_5": DistillConfig(method="DM", s2d=True, num_eval=3, vpc=5,
                                 spc=10, dpc=10, epoch_eval_train=500,
                                 batch_real=64, Iteration=5000,
                                 eval_mode="SS", eval_it=400,
                                 no_train_static=True, startIt=400),
    # sh/s2d/s2d_MTT_ms.sh (ipc=1)
    "s2d_MTT_ms": DistillConfig(method="MTT", s2d=True, num_eval=3, spc=2,
                                dpc=2, vpc=1, epoch_eval_train=500,
                                syn_steps=10, expert_epochs=1,
                                max_start_epoch=10, lr_teacher=0.01,
                                Iteration=10000, eval_it=400,
                                no_train_static=True, startIt=400,
                                batch_train=256, train_lr=True),
    # sh/s2d/s2d_MTT_ms_5.sh (ipc=5)
    "s2d_MTT_ms_5": DistillConfig(method="MTT", s2d=True, num_eval=3,
                                  spc=10, dpc=10, vpc=5,
                                  epoch_eval_train=500, syn_steps=5,
                                  expert_epochs=1, max_start_epoch=10,
                                  lr_dynamic=1e4, lr_hal=1e-3,
                                  lr_teacher=0.01, Iteration=10000,
                                  eval_mode="SS", eval_it=200,
                                  no_train_static=True, batch_train=128,
                                  batch_syn=128, startIt=200),
    # sh/s2d/s2d_MTT_ms_K400.sh
    "s2d_MTT_ms_K400": DistillConfig(method="MTT", dataset="Kinetics400",
                                     s2d=True, num_eval=3, spc=2, dpc=2,
                                     vpc=1, epoch_eval_train=500,
                                     syn_steps=10, expert_epochs=1,
                                     max_start_epoch=10, lr_teacher=0.01,
                                     Iteration=10000, eval_it=1000,
                                     no_train_static=True, batch_train=256,
                                     batch_syn=256, eval_mode="top5",
                                     frames=8, shard_store=True),
    # sh/baseline/buffer.sh
    "buffer": BufferConfig(num_experts=30, lr_teacher=0.01),
}


def get_preset(name: str):
    if name not in _PRESETS:
        raise KeyError(f"unknown preset: {name} (known: {sorted(_PRESETS)})")
    return dataclasses.replace(_PRESETS[name])
