"""The S2D set's hallucinator in plain float32: it composes the videos every
student net trains on, whatever the net.

One Conv3d(4 -> 3, k=3, padding=1) over the static still broadcast over the
frames (RGB) with the dynamic channel appended (the reference repository's
``utils.py`` Conv3DNet).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Quant, conv


def hallucinate(weight, bias, static, dynamic, quant: Quant = None):
    """Videos (B, F, H, W, 3) from stills (B, H, W, 3) and motion
    (B, F, H, W, 1): Conv3d(4 -> 3, k=3, padding=1) over [still | motion]."""
    b, f, h, w, _ = dynamic.shape
    s = static.permute(0, 3, 1, 2)[:, :, None].expand(b, 3, f, h, w)
    x = torch.cat([s, dynamic.permute(0, 4, 1, 2, 3)], dim=1)
    y = conv(F.conv3d, x, weight, bias, quant, padding=1)
    return y.permute(0, 2, 3, 4, 1)
