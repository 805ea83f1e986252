"""Plain float32 ConvNet3D and hallucinator, the yardstick of the benchmark.

Written from the published description (the reference repository's
``networks.py`` ConvNet3D and ``utils.py`` Conv3DNet) in plain PyTorch
operations. It imports nothing of the program under test.

* ConvNet3D 64/128/128, depth 3: Conv3d k=(3,7,7), stride (1,2,2), padding
  (1,3,3), ReLU, MaxPool3d (1,2,2) after the first block and (2,2,2) after
  the later ones; the head is AvgPool3d (2,2,2) stride 1 when the image is
  wider than 64 pixels, else (2,1,1); dropout 0.5 in training from a given
  keep-mask; a 1x1x1 conv to the classes; the max over time. The first
  stage is the plain Conv3d + ReLU + MaxPool (the program fuses it).
* The hallucinator: one Conv3d(4 -> 3, k=3, padding=1) over the static
  still broadcast over the frames (RGB) with the dynamic channel appended.

The parameters live in one flat vector θ in the order the expert buffers
use: leaves sorted by their flax names (a layer's ``bias`` before its
``kernel``), conv kernels laid out (D, H, W, in, out).

``quant``, where given, computes every convolution in a lower precision
(the control of ``correct``): ``quant.operand`` rounds its input and weight
(and their gradients), ``quant.result`` the gradient its output receives.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FIRST_WIDTH, WIDTH, DEPTH = 64, 128, 3
KEEP_PROB = 0.5
Quant = Optional[object]


def leaves(channel: int, num_classes: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape (D, H, W, in, out) or (out,)) of each leaf of θ, in the
    flat vector's order."""
    out, cin = [], channel
    for d in range(DEPTH):
        o = FIRST_WIDTH if d == 0 else WIDTH
        out += [(f"conv{d}.bias", (o,)), (f"conv{d}.kernel", (3, 7, 7, cin, o))]
        cin = o
    out += [("head.bias", (num_classes,)),
            ("head.kernel", (1, 1, 1, cin, num_classes))]
    return out


def num_params(channel: int, num_classes: int) -> int:
    return sum(math.prod(s) for _, s in leaves(channel, num_classes))


def fan_in(shape: Tuple[int, ...]) -> int:
    """A kernel's fan-in: the product of all but the output axis."""
    return math.prod(shape[:-1])


def unflatten(theta: torch.Tensor, channel: int, num_classes: int
              ) -> Dict[str, torch.Tensor]:
    """θ -> {name: tensor}; kernels come out in torch's (out, in, D, H, W)."""
    out, i = {}, 0
    for name, shape in leaves(channel, num_classes):
        n = math.prod(shape)
        t = theta[i:i + n].reshape(shape)
        out[name] = t.permute(4, 3, 0, 1, 2) if len(shape) == 5 else t
        i += n
    return out


def split_leaves(theta: torch.Tensor, channel: int, num_classes: int
                 ) -> Dict[str, torch.Tensor]:
    """θ (..., P) -> {name: (..., n)}, the flat pieces of each leaf."""
    out, i = {}, 0
    for name, shape in leaves(channel, num_classes):
        n = math.prod(shape)
        out[name] = theta[..., i:i + n]
        i += n
    return out


def init_theta(generator: torch.Generator, channel: int, num_classes: int,
               device) -> torch.Tensor:
    """A fresh net's θ: torch's default conv init, each conv's weight (in
    torch's (out, in, D, H, W) layout) then its bias drawn U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) from ``generator``, layer by layer, the head last."""
    drawn = {}
    for d in range(DEPTH + 1):
        name = f"conv{d}" if d < DEPTH else "head"
        shape = dict(leaves(channel, num_classes))[f"{name}.kernel"]
        bound = 1.0 / math.sqrt(fan_in(shape))
        w = torch.empty((shape[4], shape[3]) + shape[:3], device=device)
        w.uniform_(-bound, bound, generator=generator)
        b = torch.empty(shape[4], device=device)
        b.uniform_(-bound, bound, generator=generator)
        drawn[f"{name}.kernel"] = w.permute(2, 3, 4, 1, 0)
        drawn[f"{name}.bias"] = b
    return torch.cat([drawn[n].reshape(-1)
                      for n, _ in leaves(channel, num_classes)])


def keep_mask_shape(frames: int, im_size: int) -> Tuple[int, int, int, int]:
    """(C, T', H', W') of one clip's dropout mask: the head's AvgPool output
    for square (frames, im_size, im_size) clips."""
    h = im_size
    for d in range(DEPTH):
        h = ((h - 1) // 2 + 1) // 2
        frames = frames if d == 0 else frames // 2
    kt, kh, kw = head_window(im_size > 64)
    return (WIDTH, frames - kt + 1, h - kh + 1, h - kw + 1)


def head_window(wide: bool) -> Tuple[int, int, int]:
    return (2, 2, 2) if wide else (2, 1, 1)


def conv3d(x, w, b, quant: Quant = None, **kw):
    if quant is None:
        return F.conv3d(x, w, b, **kw)
    return quant.result(F.conv3d(quant.operand(x), quant.operand(w), b, **kw))


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, im_size: int,
            keep: Optional[torch.Tensor] = None, quant: Quant = None):
    """Logits of clips x (B, F, H, W, C). ``keep`` (B, C, T', H', W') bool is
    the dropout keep-mask (training), None in evaluation."""
    h = x.permute(0, 4, 1, 2, 3)
    for d in range(DEPTH):
        h = conv3d(h, params[f"conv{d}.kernel"], params[f"conv{d}.bias"],
                   quant, stride=(1, 2, 2), padding=(1, 3, 3))
        h = F.max_pool3d(F.relu(h), (1, 2, 2) if d == 0 else (2, 2, 2))
    h = F.avg_pool3d(h, head_window(im_size > 64), stride=1)
    if keep is not None:
        h = torch.where(keep, h / KEEP_PROB, torch.zeros_like(h))
    h = F.conv3d(h, params["head.kernel"], params["head.bias"])
    return h[:, :, :, 0, 0].amax(dim=2)


def hallucinate(weight, bias, static, dynamic, quant: Quant = None):
    """Videos (B, F, H, W, 3) from stills (B, H, W, 3) and motion
    (B, F, H, W, 1): Conv3d(4 -> 3, k=3, padding=1) over [still | motion]."""
    b, f, h, w, _ = dynamic.shape
    s = static.permute(0, 3, 1, 2)[:, :, None].expand(b, 3, f, h, w)
    x = torch.cat([s, dynamic.permute(0, 4, 1, 2, 3)], dim=1)
    y = conv3d(x, weight, bias, quant, padding=1)
    return y.permute(0, 2, 3, 4, 1)


def masked_ce(logits, y, w, denom):
    """Mean cross entropy over the rows of weight 1, divided by ``denom``."""
    logp = F.log_softmax(logits, dim=-1)
    return (-logp.gather(1, y[:, None])[:, 0] * w).sum() / denom
