"""ConvNet3D — the video classifier the S2D-MTT student uses.

Port of ``video_distillation_tpu/models/convnet3d.py`` (parity with the
reference ``networks.py:727-814``):

* depth-``net_depth`` stack of Conv3d k=(3,7,7), stride (1,2,2), padding
  (1,3,3); 64 channels in the first layer, ``net_width`` after;
* activation, then MaxPool3d (1,2,2) after the first block and (2,2,2)
  after the later ones;
* head: AvgPool3d (2,2,2) stride 1 when im_size[0] > 64, else (2,1,1);
  Dropout(0.5) in train mode; 1x1x1 conv to the classes; max over time.

The public input layout is the JAX package's ``(B, F, H, W, C)``; inside,
the net runs NCDHW. The first stage is fused as the JAX package fuses it
(``convnet3d.py:85-101``), under the same condition: max-pooling, no norm,
a monotone activation (pool and activation then commute) and H, W
divisible by 4. It is ``layers.s2d2_conv_pool``: the s2d2 pack kernel, one
stride-2 5x5 cuDNN conv over the packed view, the phase-max kernel and
the bias, added after the pool; then the activation. Every other
configuration (swish, for one) takes the plain Conv3d + activation +
MaxPool stage. ``fuse_first_stage=False`` forces the plain stage; it exists
for A/B measurements, as the JAX package's ``FUSE_FIRST_STAGE``. Both
stages read the same ``convs[0]`` Conv3d parameters, so the flat parameter
layout and the expert buffers do not depend on it.

Mixed precision: each stage casts its conv weights to the activation's
dtype, and ``fp32_stages`` names stages that run in fp32 (the JAX
package's islands). For a bf16 S2D-MTT unroll the caller islands the
``head``: x is cast to fp32 before the AvgPool and the logits back to the
compute dtype after the max over time. In torch the second-order pass
(``create_graph``) differentiates this same forward in its own dtypes, so
the island the JAX package applies only to its HVP pass is applied to the
forward here as well. The JAX package's island sweep found an all-bf16
second-order pass non-finite at 112x112x16 and only the head island cured
it (BASELINE.md, round 5); the port keeps that island.

Dropout draws its keep-mask from an explicit ``torch.Generator``, or takes
one (``keep_mask``, in the JAX layout ``(B, T', H', W', C)``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3d_s2
from .layers import (activation, avg_pool, check_stages, init_conv_, max_pool,
                     s2d2_conv_pool, stage_island)

# pool-before-activation commutes only for monotone activations
_MONOTONE = ("relu", "leakyrelu", "sigmoid")


class ConvNet3D(nn.Module):
    def __init__(self, channel: int = 3, num_classes: int = 50,
                 net_width: int = 128, net_depth: int = 3,
                 net_act: str = "relu", net_norm: str = "none",
                 net_pooling: str = "maxpooling", frames: int = 16,
                 im_size: Tuple[int, int] = (112, 112),
                 dropout_rate: float = 0.5, *,
                 generator: Optional[torch.Generator] = None,
                 device=None, fuse_first_stage: bool = True):
        super().__init__()
        if net_norm != "none":
            raise NotImplementedError(
                f"ConvNet3D net_norm={net_norm!r}: only 'none' is ported "
                "(the factory forces it; other norms come with ROADMAP A.13)")
        if net_pooling not in ("maxpooling", "avgpooling", "none"):
            raise ValueError(f"unknown net_pooling: {net_pooling}")
        self.net_act, self.net_pooling = net_act, net_pooling
        self.frames, self.im_size = frames, tuple(im_size)
        self.dropout_rate = dropout_rate
        self.fuse_first_stage = fuse_first_stage
        self.act = activation(net_act)
        self.convs = nn.ModuleList()
        cin = channel
        for d in range(net_depth):
            feats = 64 if d == 0 else net_width
            self.convs.append(nn.Conv3d(cin, feats, (3, 7, 7), stride=(1, 2, 2),
                                        padding=(1, 3, 3), device=device))
            cin = feats
        self.head = nn.Conv3d(cin, num_classes, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """A fresh net: torch-default convs and head from ``generator``."""
        for m in (*self.convs, self.head):
            init_conv_(m, generator)

    def forward(self, x, train: bool = False, output: str = "logits",
                keep_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fp32_stages: Sequence[str] = ()):
        fp32_stages = check_stages(fp32_stages)
        base_dt = x.dtype
        for d, conv in enumerate(self.convs):
            x = stage_island(x, f"s{d + 1}", base_dt, fp32_stages)
            if d == 0 and self.fuses_first_stage(x.shape[2], x.shape[3]):
                x = self.act(s2d2_conv_pool(x, conv.weight.to(x.dtype),
                                            conv.bias.to(x.dtype)))
                continue
            if d == 0:
                x = x.permute(0, 4, 1, 2, 3)  # (B, F, H, W, C) -> NCDHW
            w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
            if conv3d_s2.routes(x, w):
                x = conv3d_s2.conv3d_s2(x, w, b)
            else:
                x = F.conv3d(x, w, b, stride=(1, 2, 2), padding=(1, 3, 3))
            x = self.act(x)
            if self.net_pooling == "maxpooling":
                x = max_pool(x, (1, 2, 2) if d == 0 else (2, 2, 2))
            elif self.net_pooling == "avgpooling":
                x = avg_pool(x, (2, 2, 2))

        if output in ("feat", "both"):
            # flatten in the JAX package's (T, H, W, C) order
            feat = x.permute(0, 2, 3, 4, 1).flatten(1).to(base_dt)
            if output == "feat":
                return feat

        window = (2, 2, 2) if self.im_size[0] > 64 else (2, 1, 1)
        x = stage_island(x, "head", base_dt, fp32_stages)
        x = avg_pool(x, window, strides=(1, 1, 1))
        if train and self.dropout_rate > 0:
            x = self._dropout(x, keep_mask, generator)
        x = F.conv3d(x, self.head.weight.to(x.dtype), self.head.bias.to(x.dtype))
        if x.shape[3] != 1 or x.shape[4] != 1:
            raise ValueError(f"ConvNet3D head expects 1x1 spatial, got "
                             f"{tuple(x.shape[3:])}: im_size too large for the depth")
        logits = x[:, :, :, 0, 0].amax(dim=2).to(base_dt)
        if output == "both":
            return logits, feat
        return logits

    def fuses_first_stage(self, h: int, w: int) -> bool:
        """Whether the first stage runs fused on H x W input
        (``convnet3d.py:93-97``)."""
        return (self.fuse_first_stage and self.net_pooling == "maxpooling"
                and self.net_act in _MONOTONE and h % 4 == 0 and w % 4 == 0)

    def clip_elements(self, frames: int, h: int, w: int) -> int:
        """Elements of the widest activation one (frames, h, w) clip makes:
        the first conv's output before its pool (in the fused stage, the
        GEMM's four pool phases at H/4 x W/4)."""
        return self.convs[0].out_channels * frames * -(-h // 2) * -(-w // 2)

    def keep_mask_shape(self, frames: int, h: int, w: int) -> Tuple[int, ...]:
        """(T', H', W', C): one clip's dropout keep-mask in the JAX layout,
        the shape of the head's input after its AvgPool."""
        for d, conv in enumerate(self.convs):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # k 7, stride 2, pad 3
            if self.net_pooling == "maxpooling":
                frames = frames if d == 0 else frames // 2
                h, w = h // 2, w // 2
            elif self.net_pooling == "avgpooling":
                frames, h, w = frames // 2, h // 2, w // 2
        kt, kh, kw = (2, 2, 2) if self.im_size[0] > 64 else (2, 1, 1)
        return (frames - kt + 1, h - kh + 1, w - kw + 1,
                self.convs[-1].out_channels)

    def _dropout(self, x, keep_mask, generator):
        keep_prob = 1.0 - self.dropout_rate
        if keep_mask is None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        else:
            keep = keep_mask.to(device=x.device, dtype=torch.bool).permute(0, 4, 1, 2, 3)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
