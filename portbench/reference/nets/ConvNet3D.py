"""Plain float32 ConvNet3D, the student net of the S2D cells.

Written from the published description (the reference repository's
``networks.py`` ConvNet3D) in plain PyTorch operations. It imports nothing
of the program under test. Its widths come from the configuration's
``model``: ``first_width``, ``net_width``, ``net_depth``, ``kernel`` and
``dropout``.

* ``net_depth`` blocks of Conv3d k=``kernel`` (3, 7, 7), stride (1, 2, 2),
  padding half the kernel, ReLU, MaxPool3d (1, 2, 2) after the first block
  and (2, 2, 2) after the later ones; the head is AvgPool3d (2, 2, 2)
  stride 1 when the image is wider than 64 pixels, else (2, 1, 1); dropout
  in training from a given keep-mask; a 1x1x1 conv to the classes; the max
  over time. The first stage is the plain Conv3d + ReLU + MaxPool (the
  program fuses it).
* The evaluation gives the net its clips as they are (``prepare``).

The parameters live in one flat vector θ in the order the expert buffers
use: leaves sorted by their flax names (a layer's ``bias`` before its
``kernel``), conv kernels laid out (D, H, W, in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.ops import Quant, conv, split

STRIDE = (1, 2, 2)


def leaves(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape (D, H, W, in, out) or (out,)) of each leaf of θ, in the
    flat vector's order."""
    out, cin = [], m["channel"]
    for d in range(m["net_depth"]):
        o = m["first_width"] if d == 0 else m["net_width"]
        out += [(f"conv{d}.bias", (o,)),
                (f"conv{d}.kernel", tuple(m["kernel"]) + (cin, o))]
        cin = o
    k = m["num_classes"]
    out += [("head.bias", (k,)), ("head.kernel", (1, 1, 1, cin, k))]
    return out


def _fan_in(shape: Tuple[int, ...]) -> int:
    """A kernel's fan-in: the product of all but the output axis."""
    return math.prod(shape[:-1])


def init_bounds(m: dict) -> List[float]:
    """Each leaf's init bound 1/sqrt(fan_in of its layer's kernel)."""
    shapes = dict(leaves(m))
    return [1.0 / math.sqrt(_fan_in(shapes[name.replace(".bias", ".kernel")]))
            for name, _ in leaves(m)]


def unflatten(theta: torch.Tensor, m: dict) -> Dict[str, torch.Tensor]:
    """θ -> {name: tensor}; kernels come out in torch's (out, in, D, H, W)."""
    out = {}
    for (name, shape), t in zip(leaves(m), split(theta, leaves(m)).values()):
        t = t.reshape(shape)
        out[name] = t.permute(4, 3, 0, 1, 2) if len(shape) == 5 else t
    return out


def init_theta(generator: torch.Generator, m: dict, device) -> torch.Tensor:
    """A fresh net's θ: torch's default conv init, each conv's weight (in
    torch's (out, in, D, H, W) layout) then its bias drawn U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) from ``generator``, layer by layer, the head last."""
    shapes, drawn = dict(leaves(m)), {}
    for d in range(m["net_depth"] + 1):
        name = f"conv{d}" if d < m["net_depth"] else "head"
        shape = shapes[f"{name}.kernel"]
        bound = 1.0 / math.sqrt(_fan_in(shape))
        w = torch.empty((shape[4], shape[3]) + shape[:3], device=device)
        w.uniform_(-bound, bound, generator=generator)
        b = torch.empty(shape[4], device=device)
        b.uniform_(-bound, bound, generator=generator)
        drawn[f"{name}.kernel"] = w.permute(2, 3, 4, 1, 0)
        drawn[f"{name}.bias"] = b
    return torch.cat([drawn[n].reshape(-1) for n, _ in leaves(m)])


def _head_window(m: dict) -> Tuple[int, int, int]:
    return (2, 2, 2) if m["im_size"] > 64 else (2, 1, 1)


def keep_mask_shape(m: dict) -> Optional[Tuple[int, int, int, int]]:
    """(C, T', H', W') of one clip's dropout mask: the head's AvgPool output
    for square (frames, im_size, im_size) clips."""
    frames, h = m["frames"], m["im_size"]
    kh = m["kernel"][1]
    for d in range(m["net_depth"]):
        h = ((h + 2 * (kh // 2) - kh) // STRIDE[1] + 1) // 2
        frames = frames if d == 0 else frames // 2
    kt, kh, kw = _head_window(m)
    width = m["first_width"] if m["net_depth"] == 1 else m["net_width"]
    return (width, frames - kt + 1, h - kh + 1, h - kw + 1)


def prepare(x: torch.Tensor, m: dict) -> torch.Tensor:
    """The clips as the evaluation gives them to the net: unchanged."""
    return x


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, m: dict,
            keep: Optional[torch.Tensor] = None, quant: Quant = None):
    """Logits of clips x (B, F, H, W, C). ``keep`` (B, C, T', H', W') bool is
    the dropout keep-mask (training), None in evaluation."""
    padding = tuple(k // 2 for k in m["kernel"])
    h = x.permute(0, 4, 1, 2, 3)
    for d in range(m["net_depth"]):
        h = conv(F.conv3d, h, params[f"conv{d}.kernel"],
                 params[f"conv{d}.bias"], quant, stride=STRIDE,
                 padding=padding)
        h = F.max_pool3d(F.relu(h), (1, 2, 2) if d == 0 else (2, 2, 2))
    h = F.avg_pool3d(h, _head_window(m), stride=1)
    if keep is not None:
        h = torch.where(keep, h / (1 - m["dropout"]), torch.zeros_like(h))
    h = F.conv3d(h, params["head.kernel"], params["head.bias"])
    return h[:, :, :, 0, 0].amax(dim=2)
