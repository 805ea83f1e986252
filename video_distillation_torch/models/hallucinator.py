"""Hallucinator — composes static RGB stills and 1-channel motion volumes
into synthetic videos.

Port of ``video_distillation_tpu/models/hallucinator.py`` (parity with the
reference ``Conv3DNet``, utils.py:1178-1197): one Conv3d(cin -> 3, k=3,
pad=1). 'concat' mode broadcasts the static image over frames and appends
the dynamic channel as a 4th input channel; it runs through
``ops.hal_conv`` on every device (the Hopper kernels on CUDA, their plain
version on the CPU). 'add' mode adds the dynamic volume to the broadcast
static image and stays a plain conv, as in the JAX package.

Layouts: static (B, H, W, 3), dynamic (B, F, H, W, 1), output video
(B, F, H, W, 3) as a view of channel-planar (B, 3, F, H, W) storage.
Parameters are torch's Conv3d ``weight`` (3, cin, 3, 3, 3) and ``bias`` (3,);
``distill/params.py`` converts them from and to the JAX ``kernel`` (DHWIO)
and ``bias``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hal_conv import hal_conv
from .layers import torch_default_bound

_CIN = {"concat": 4, "add": 3}


def init_hallucinator(mode: str = "concat",
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[str, torch.Tensor]:
    """{'weight', 'bias'} with torch-default init bounds (fan_in = cin*27)."""
    if mode not in _CIN:
        raise NotImplementedError(mode)
    cin = _CIN[mode]
    bound = torch_default_bound(cin * 27)
    weight = torch.empty(3, cin, 3, 3, 3, device=device)
    bias = torch.empty(3, device=device)
    weight.uniform_(-bound, bound, generator=generator)
    bias.uniform_(-bound, bound, generator=generator)
    return {"weight": weight, "bias": bias}


def hal_apply(params: Dict[str, torch.Tensor], static, dynamic,
              mode: str = "concat"):
    """Compose (B, H, W, 3) stills and (B, F, H, W, 1) motion into
    (B, F, H, W, 3) videos with the given parameters."""
    if mode == "concat":
        return hal_conv(static, dynamic, params["weight"], params["bias"])
    if mode != "add":
        raise NotImplementedError(mode)
    b, frames, h, w, _ = dynamic.shape
    x = (static.permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, frames, h, w)
         + dynamic.permute(0, 4, 1, 2, 3))
    y = F.conv3d(x, params["weight"].to(x.dtype), params["bias"].to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


class Hallucinator(nn.Module):
    def __init__(self, mode: str = "concat", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.mode = mode
        p = init_hallucinator(mode, generator, device)
        self.weight = nn.Parameter(p["weight"])
        self.bias = nn.Parameter(p["bias"])

    def forward(self, static, dynamic):
        return hal_apply({"weight": self.weight, "bias": self.bias}, static,
                         dynamic, self.mode)
