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
the net runs NCDHW. The first stage is a plain Conv3d + activation +
MaxPool. The JAX package fuses it into an s2d2 GEMM + phase max that adds
the bias after the pool, which is the same math up to rounding.

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

from .layers import activation, avg_pool, check_stages, init_conv_, max_pool, stage_island


class ConvNet3D(nn.Module):
    def __init__(self, channel: int = 3, num_classes: int = 50,
                 net_width: int = 128, net_depth: int = 3,
                 net_act: str = "relu", net_norm: str = "none",
                 net_pooling: str = "maxpooling", frames: int = 16,
                 im_size: Tuple[int, int] = (112, 112),
                 dropout_rate: float = 0.5, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
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
        self.act = activation(net_act)
        self.convs = nn.ModuleList()
        cin = channel
        for d in range(net_depth):
            feats = 64 if d == 0 else net_width
            self.convs.append(nn.Conv3d(cin, feats, (3, 7, 7), stride=(1, 2, 2),
                                        padding=(1, 3, 3), device=device))
            cin = feats
        self.head = nn.Conv3d(cin, num_classes, 1, device=device)
        for m in (*self.convs, self.head):
            init_conv_(m, generator)

    def forward(self, x, train: bool = False, output: str = "logits",
                keep_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fp32_stages: Sequence[str] = ()):
        fp32_stages = check_stages(fp32_stages)
        x = x.permute(0, 4, 1, 2, 3)  # (B, F, H, W, C) -> NCDHW
        base_dt = x.dtype
        for d, conv in enumerate(self.convs):
            x = stage_island(x, f"s{d + 1}", base_dt, fp32_stages)
            x = F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                         stride=(1, 2, 2), padding=(1, 3, 3))
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

    def _dropout(self, x, keep_mask, generator):
        keep_prob = 1.0 - self.dropout_rate
        if keep_mask is None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        else:
            keep = keep_mask.to(device=x.device, dtype=torch.bool).permute(0, 4, 1, 2, 3)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
