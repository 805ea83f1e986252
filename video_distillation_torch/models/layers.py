"""Building blocks ConvNet3D needs: init bounds, activations, pools, and the
fp32 stage island.

Port of the matching parts of ``video_distillation_tpu/models/layers.py``.
Tensors here are NCDHW (torch's own layout); the models permute at their
public boundary.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def torch_default_bound(fan_in: int) -> float:
    """Torch's default Conv/Linear init draws weights and biases from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (layers.py:23-47)."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


@torch.no_grad()
def init_conv_(conv: nn.Conv3d, generator: Optional[torch.Generator] = None):
    """Torch-default init of a conv's weight and bias from an explicit
    generator. fan_in = in_channels * prod(kernel_size)."""
    w = conv.weight
    bound = torch_default_bound(w.shape[1] * math.prod(w.shape[2:]))
    w.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def activation(name: str):
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    if name == "swish":
        # reference Swish is x * sigmoid(x) (networks.py:12-18)
        return F.silu
    raise ValueError(f"unknown activation function: {name}")


def max_pool(x, window: Sequence[int], strides: Optional[Sequence[int]] = None):
    """VALID max-pool over the (D, H, W) dims of NCDHW x (floor output size,
    as torch and the JAX package both give)."""
    return F.max_pool3d(x, tuple(window), stride=tuple(strides or window))


def avg_pool(x, window: Sequence[int], strides: Optional[Sequence[int]] = None):
    return F.avg_pool3d(x, tuple(window), stride=tuple(strides or window))


KNOWN_STAGES = frozenset({"s1", "s2", "s3", "head"})


def check_stages(stages: Sequence[str]) -> tuple:
    unknown = set(stages) - KNOWN_STAGES
    if unknown:
        raise ValueError(f"unknown fp32 island stage(s) {sorted(unknown)}; "
                         f"known: {sorted(KNOWN_STAGES)}")
    return tuple(stages)


def stage_island(x, name: str, base_dtype, fp32_stages: Sequence[str] = ()):
    """Cast x for stage ``name``: fp32 inside an island, the caller's compute
    dtype outside (layers.py:128-155). A cast's backward is a cast, so the
    island holds in every derivative of the forward too."""
    want = torch.float32 if name in fp32_stages else base_dtype
    return x if x.dtype == want else x.to(want)
