"""Per-frame 2-D ConvNet video models with temporal aggregation heads.

Port of ``video_distillation_tpu/models/video_nets.py`` (parity with the
reference ``networks.py:537-722``): the 2-D ConvNet backbone
(``ConvNet2D``, features only) runs on every frame, and its (B, F, D)
features are aggregated over time by

* ``mean`` (VideoConvNetMean);
* ``mlp``: a learned per-feature temporal linear map, ``temporal_weight``
  (D, F, 1) and ``temporal_bias`` (D, 1) in the JAX layout (VideoConvNetMLP);
* ``lstm``, ``rnn``, ``gru``: one torch-equivalent recurrent layer (hidden D
  for the LSTM, D // 8 for RNN and GRU) whose outputs are mean-pooled over
  time;

then a Linear to the classes (the JAX ``TorchDense``). The input layout is
``(B, F, H, W, C)``.

The recurrences are plain tensor ops over time, as the JAX package's
``lax.scan``, with torch's gate equations and its U(-1/sqrt(hidden),
1/sqrt(hidden)) init; not ``nn.LSTM``/``nn.GRU``, whose cuDNN kernels have
no double backward (raw MTT differentiates the unroll to second order).
Their weights are torch's ``weight_ih`` (G*hidden, D), ``weight_hh``
(G*hidden, hidden), ``bias_ih``, ``bias_hh``, gates in torch's order (i, f,
g, o; r, z, n); the JAX ``w_ih`` / ``w_hh`` are their transposes
(``distill/params.py``). The MLP head's bias is kept as (1, D), the
transpose of the JAX (D, 1).

The head's size depends on the input's H and W, so the model is built for
the size it will see (the evaluation's 24:-24 crop gives H - 48).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .convnet2d import ConvNet2D
from .layers import check_stages, init_conv_, stage_island

HEADS = ("mean", "mlp", "lstm", "rnn", "gru")
_GATES = {"rnn": 1, "lstm": 4, "gru": 3}


class Recurrent(nn.Module):
    """Single-layer RNN / LSTM / GRU over (B, T, D) inputs, returning the
    (B, T, hidden) outputs (the JAX ``_Recurrent``)."""

    def __init__(self, d: int, hidden: int, cell: str, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cell, self.hidden, self.gates = cell, hidden, _GATES[cell]
        gh = self.gates * hidden
        self.weight_ih = nn.Parameter(torch.empty(gh, d, device=device))
        self.weight_hh = nn.Parameter(torch.empty(gh, hidden, device=device))
        self.bias_ih = nn.Parameter(torch.empty(gh, device=device))
        self.bias_hh = nn.Parameter(torch.empty(gh, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.hidden)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        """In x's dtype (the weights are cast to it)."""
        w_ih, w_hh, b_ih, b_hh = (p.to(x.dtype) for p in (
            self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh))
        b = x.shape[0]
        # the input projection hoisted out of the loop, as the JAX scan does
        xp = x @ w_ih.T + b_ih
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        ys = []
        for t in range(x.shape[1]):
            hh = h @ w_hh.T + b_hh
            if self.cell == "lstm":
                i, f, g, o = (xp[:, t] + hh).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            elif self.cell == "gru":
                xr, xz, xn = xp[:, t].chunk(3, dim=-1)
                hr, hz, hn = hh.chunk(3, dim=-1)
                r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
                n = torch.tanh(xn + r * hn)
                h = (1.0 - z) * n + z * h
            else:
                h = torch.tanh(xp[:, t] + hh)
            ys.append(h)
        return torch.stack(ys, dim=1)


class VideoConvNet(nn.Module):
    def __init__(self, channel: int = 3, num_classes: int = 10,
                 net_width: int = 128, net_depth: int = 3,
                 net_act: str = "relu", net_norm: str = "instancenorm",
                 net_pooling: str = "avgpooling",
                 im_size: Tuple[int, int] = (64, 64), frames: int = 16,
                 head: str = "mean", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown temporal head: {head}")
        self.head_kind = head
        self.backbone = ConvNet2D(channel, num_classes, net_width, net_depth,
                                  net_act, net_norm, net_pooling,
                                  tuple(im_size), generator=generator,
                                  device=device, with_head=False)
        d = self.backbone.feat_dim
        if head == "mlp":
            self.temporal_weight = nn.Parameter(
                torch.empty(d, frames, 1, device=device))
            self.temporal_bias = nn.Parameter(torch.empty(1, d, device=device))
        elif head != "mean":
            self.recurrent = Recurrent(d, d if head == "lstm" else d // 8,
                                       head, generator=generator,
                                       device=device)
        feat = self.recurrent.hidden if head in _GATES else d
        self.head = nn.Linear(feat, num_classes, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """A fresh net from ``generator``: the backbone, then the temporal
        head (N(0, 1) for the MLP's), then the Linear."""
        self.backbone.reset_parameters(generator)
        if self.head_kind == "mlp":
            self.temporal_weight.normal_(generator=generator)
            self.temporal_bias.normal_(generator=generator)
        elif self.head_kind != "mean":
            self.recurrent.reset_parameters(generator)
        init_conv_(self.head, generator)

    def clip_elements(self, frames: int, h: int, w: int) -> int:
        """Elements of the widest activation one clip makes (the backbone's
        first conv output over its frames)."""
        return self.backbone.clip_elements(frames, h, w)

    def forward(self, x, train: bool = True, output: str = "logits",
                keep_mask=None, generator=None,
                fp32_stages: Sequence[str] = ()):
        """``keep_mask`` and ``generator`` are accepted for the shared
        training signature; no layer of this net drops out. A 'head' fp32
        stage runs the temporal head and the Linear in fp32."""
        fp32_stages = check_stages(fp32_stages)
        base_dt = x.dtype
        b, f = x.shape[:2]
        out = self.backbone(x.flatten(0, 1), output="feat").unflatten(0, (b, f))
        out = stage_island(out, "head", base_dt, fp32_stages)
        if self.head_kind == "mean":
            feat = out.mean(dim=1)
        elif self.head_kind == "mlp":
            w = self.temporal_weight.to(out.dtype)[..., 0]
            feat = torch.einsum("bfd,df->bd", out, w) + self.temporal_bias.to(out.dtype)
        else:
            feat = self.recurrent(out).mean(dim=1)
        if output == "feat":
            return feat.to(base_dt)
        logits = F.linear(feat, self.head.weight.to(feat.dtype),
                          self.head.bias.to(feat.dtype)).to(base_dt)
        if output == "both":
            return logits, feat.to(base_dt)
        return logits
