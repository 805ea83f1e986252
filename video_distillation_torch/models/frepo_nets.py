"""FRePo's evaluation-pool image nets: KIP_ConvNet and Conv.

Port of ``video_distillation_tpu/models/frepo_nets.py`` (capability
equivalents of the reference's ``FRePo/lib/models/networks.py``
``KIP_ConvNet`` :88-182 and ``Conv`` :185-237), through the zoo's
interface (``layers.ImageModel``: NHWC input, ``output`` in
{'logits', 'feat', 'both'}, the ``train`` flag). Both use flax's own
``nn.Conv``/``nn.Dense`` inits for fresh nets (lecun-normal kernels, zero
biases), except KIP_ConvNet's head bias, N(0, 0.1). KIP_ConvNet's convs pad
'SAME'; Conv's width doubles a block, and 1-channel input gets k//2 + 2
padding on its first conv. The norms are FRePo's names (``frepo_norm``);
'batch' is flax's BatchNorm at flax momentum 0.1 (the running value keeps
10% of its past, as the JAX package has it).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (NORM_EPS, BatchNorm, ChannelLayerNorm, GroupNorm,
                     ImageModel, activation, apply_norm, avg_pool,
                     nhwc_flatten)

# flax's truncated normal of unit variance is cut at 2 std and rescaled by
# this (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def frepo_norm(normalization: str, channels: int, device=None):
    """(module, flax module name) for FRePo's norm names; (None, None) for
    'identity'/'none'."""
    if normalization in ("identity", "none"):
        return None, None
    if normalization == "batch":
        return BatchNorm(channels, momentum=0.1, device=device), "BatchNorm"
    if normalization == "layer":
        return ChannelLayerNorm(channels, device=device), "LayerNorm"
    groups = {"group": 32, "group1": 1, "instance": channels}
    if normalization in groups:
        return (GroupNorm(groups[normalization], channels, eps=NORM_EPS,
                          device=device), "GroupNorm")
    raise ValueError(f"unknown normalization: {normalization}")


@torch.no_grad()
def lecun_normal_(weight, generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal`` (variance 1/fan_in, truncated at 2 std) on a
    torch Conv2d or Linear weight, fan_in = in_channels x kernel taps."""
    std = math.sqrt(1.0 / math.prod(weight.shape[1:])) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class _FRePoNet(ImageModel):
    def _add_norm(self, normalization: str, channels: int, device):
        norm, kind = frepo_norm(normalization, channels, device)
        self.norms.append(norm or nn.Identity())
        if norm is not None:
            i = sum(1 for t in self.jax_tree if t[0][0].startswith(kind))
            self.jax_tree.append(((f"{kind}_{i}",),
                                  f"norms.{len(self.norms) - 1}", "norm"))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, BatchNorm, ChannelLayerNorm)):
                m.reset_parameters()


class KIPConvNet(_FRePoNet):
    """A stem conv + ``depth`` blocks of [norm?, conv, act, pool];
    features = the flattened (or global-average-pooled) block stack."""

    def __init__(self, channel: int = 3, num_classes: int = 10,
                 width: int = 128, depth: int = 3,
                 kernel_size: Tuple[int, int] = (3, 3), net_act: str = "relu",
                 normalization: str = "identity", pooling: str = "avg",
                 use_gap: bool = False, im_size: Tuple[int, int] = (32, 32),
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if pooling not in ("avg", "max", "identity"):
            raise ValueError(f"unknown pooling: {pooling}")
        self.act, self.pooling, self.use_gap = (activation(net_act), pooling,
                                                use_gap)
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        for i in range(depth + 1):
            if i > 0:
                self._add_norm(normalization, width, device)
            self.convs.append(nn.Conv2d(channel if i == 0 else width, width,
                                        tuple(kernel_size), padding="same",
                                        device=device))
            self.jax_tree.append(((f"Conv_{i}",), f"convs.{i}", "conv"))
        h, w = im_size
        if pooling != "identity":
            h, w = h >> depth, w >> depth
        self.head = nn.Linear(width * (1 if use_gap else h * w), num_classes,
                              device=device)
        self.jax_tree.append((("Dense_0",), "head", "dense"))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        nn.init.normal_(self.head.bias, 0.0, 0.1, generator=generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = self.act(self.convs[0](self.image_input(x)))
        for conv, norm in zip(self.convs[1:], self.norms):
            x = self.act(conv(apply_norm(norm, x, train)))
            if self.pooling == "avg":
                x = avg_pool(x, (2, 2))
            elif self.pooling == "max":
                x = F.max_pool2d(x, 2, 2)
        if self.use_gap:
            x = x.mean((2, 3), keepdim=True)
        return self.heads(nhwc_flatten(x), output)


class FRePoConv(_FRePoNet):
    """Conv: ``depth`` blocks of [norm? (not the first), conv of width
    ``width * 2**i``, relu, 2x2 average pool]."""

    def __init__(self, channel: int = 3, num_classes: int = 10,
                 width: int = 128, depth: int = 3,
                 kernel_size: Tuple[int, int] = (3, 3),
                 normalization: str = "identity",
                 im_size: Tuple[int, int] = (32, 32), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cin, (h, w) = channel, im_size
        k = kernel_size[0] // 2
        for i in range(depth):
            if i != 0:
                self._add_norm(normalization, cin, device)
            pad = k + 2 if (i == 0 and channel == 1) else k
            self.convs.append(nn.Conv2d(cin, width * 2 ** i,
                                        tuple(kernel_size), padding=pad,
                                        device=device))
            self.jax_tree.append(((f"Conv_{i}",), f"convs.{i}", "conv"))
            cin = width * 2 ** i
            h = (h + 2 * pad - kernel_size[0] + 1) // 2
            w = (w + 2 * pad - kernel_size[1] + 1) // 2
        self.head = nn.Linear(cin * h * w, num_classes, device=device)
        self.jax_tree.append((("Dense_0",), "head", "dense"))
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = self.image_input(x)
        for i, conv in enumerate(self.convs):
            if i != 0:
                x = apply_norm(self.norms[i - 1], x, train)
            x = avg_pool(F.relu(conv(x)), (2, 2))
        return self.heads(nhwc_flatten(x), output)
