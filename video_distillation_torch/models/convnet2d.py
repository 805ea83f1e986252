"""ConvNet (2D) — the DC-lineage image ConvNet with depth/width/act/norm/pool
knobs, which static-memory learning trains.

Port of ``video_distillation_tpu/models/convnet2d.py`` (parity with the
reference ``networks.py:42-116``): each block is Conv2d(k=3, pad 1; pad 3
for the first layer of 1-channel inputs) -> norm -> act -> pool(2,2); the
head is a single Linear. The public input layout is the JAX package's
``(B, H, W, C)``; inside, the net runs NCHW. The features are flattened in
the JAX package's (H, W, C) order, so the head's weight carries across as a
plain transpose (``distill/params.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import activation, avg_pool, init_conv_, max_pool, norm_layer


class ConvNet2D(nn.Module):
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
        self.act = activation(net_act)
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cin, (h, w) = channel, im_size
        for d in range(net_depth):
            pad = 3 if (channel == 1 and d == 0) else 1
            self.convs.append(nn.Conv2d(cin, net_width, 3, padding=pad,
                                        device=device))
            self.norms.append(norm_layer(net_norm, net_width, device)
                              or nn.Identity())
            cin, h, w = net_width, h + 2 * pad - 2, w + 2 * pad - 2
            if net_pooling != "none":
                h, w = h // 2, w // 2
        self.feat_dim = cin * h * w
        self.head = (nn.Linear(self.feat_dim, num_classes, device=device)
                     if with_head else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """A fresh net: torch-default convs and head from ``generator``, norm
        scales 1 and biases 0."""
        for m in (*self.convs, self.head):
            if m is not None:
                init_conv_(m, generator)
        for n in self.norms:
            if isinstance(n, nn.GroupNorm):
                n.reset_parameters()

    def clip_elements(self, frames: int, h: int, w: int) -> int:
        """Elements of the widest activation ``frames`` (h, w) images make:
        the first conv's output."""
        return self.convs[0].out_channels * frames * h * w

    def forward(self, x, train: bool = True, output: str = "logits"):
        """``train`` is accepted for the JAX signature; no layer of this net
        depends on it."""
        x = x.permute(0, 3, 1, 2)  # (B, H, W, C) -> NCHW
        for conv, norm in zip(self.convs, self.norms):
            x = self.act(norm(conv(x)))
            if self.net_pooling == "maxpooling":
                x = max_pool(x, (2, 2))
            elif self.net_pooling == "avgpooling":
                x = avg_pool(x, (2, 2))
        feat = x.permute(0, 2, 3, 1).flatten(1)  # the JAX (H, W, C) order
        if output == "feat":
            return feat
        logits = self.head(feat)
        if output == "both":
            return logits, feat
        return logits
