"""ConvNet (2D) — the DC-lineage image ConvNet with depth/width/act/norm/pool
knobs, which static-memory learning trains.

Port of ``video_distillation_tpu/models/convnet2d.py`` (parity with the
reference ``networks.py:42-116``): each block is Conv2d(k=3, pad 1; pad 3
for the first layer of 1-channel inputs) -> norm -> act -> pool(2,2); the
head is a single Linear. The public input layout is the JAX package's
``(B, H, W, C)`` (or ``(B, 1, H, W, C)``, ``layers.ImageModel``); inside,
the net runs NCHW. The features are flattened in the JAX package's (H, W,
C) order, so the head's weight carries across as a plain transpose
(``distill/params.py``). With ``net_norm='batchnorm'`` (``ConvNetBN``,
``ConvNetASwishBN``) each block's norm is flax's BatchNorm at momentum 0.9,
whose running statistics are the module's buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import (ImageModel, activation, apply_norm, avg_pool,
                     max_pool, nhwc_flatten, norm_layer)


class ConvNet2D(ImageModel):
    def __init__(self, channel: int = 3, num_classes: int = 10,
                 net_width: int = 128, net_depth: int = 3,
                 net_act: str = "relu", net_norm: str = "instancenorm",
                 net_pooling: str = "avgpooling",
                 im_size: Tuple[int, int] = (32, 32), *,
                 generator: Optional[torch.Generator] = None, device=None,
                 with_head: bool = True):
        """``with_head=False`` builds the feature extractor alone (no Linear,
        ``output='feat'`` only), as a flax ConvNet2D called for features
        never creates its head (a VideoConvNet's backbone)."""
        super().__init__()
        if net_pooling not in ("maxpooling", "avgpooling", "none"):
            raise ValueError(f"unknown net_pooling: {net_pooling}")
        self.net_norm, self.net_pooling = net_norm, net_pooling
        self.max_pools = net_pooling == "maxpooling"
        self.act = activation(net_act)
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        norm_kind = {"layernorm": "LayerNorm",
                     "batchnorm": "BatchNorm"}.get(net_norm, "GroupNorm")
        cin, (h, w) = channel, im_size
        for d in range(net_depth):
            pad = 3 if (channel == 1 and d == 0) else 1
            self.convs.append(nn.Conv2d(cin, net_width, 3, padding=pad,
                                        device=device))
            self.jax_tree.append(((f"TorchConv_{d}",), f"convs.{d}",
                                  "torchconv"))
            self.norms.append(norm_layer(net_norm, net_width, device)
                              or nn.Identity())
            if net_norm != "none":
                self.jax_tree.append(((f"{norm_kind}_{d}",), f"norms.{d}",
                                      "norm"))
            cin, h, w = net_width, h + 2 * pad - 2, w + 2 * pad - 2
            if net_pooling != "none":
                h, w = h // 2, w // 2
        self.feat_dim = cin * h * w
        self.head = (nn.Linear(self.feat_dim, num_classes, device=device)
                     if with_head else None)
        if with_head:
            self.jax_tree.append((("TorchDense_0",), "head", "torchdense"))
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        """``train`` selects a BatchNorm's batch or running statistics; no
        other layer depends on it. Dropout arguments are accepted and
        ignored (the net has none)."""
        x = self.image_input(x)
        for conv, norm in zip(self.convs, self.norms):
            x = self.act(apply_norm(norm, conv(x), train))
            if self.net_pooling == "maxpooling":
                x = max_pool(x, (2, 2))
            elif self.net_pooling == "avgpooling":
                x = avg_pool(x, (2, 2))
        return self.heads(nhwc_flatten(x), output)
