"""Plain float32 VideoConvNetMean: a 2-D ConvNet on every frame, the mean of
its features over time, a Linear to the classes.

Written from the published description (the reference repository's
``networks.py:537-722`` VideoConvNet with the ``mean`` head, and its
``ConvNet`` at instance norm and average pooling) in plain PyTorch
operations. It imports nothing of the program under test. Its widths come
from the configuration's ``model``: ``net_width``, ``net_depth``, and
``net_norm`` 'instancenorm', ``net_pooling`` 'avgpooling', ``net_act``
'relu', the only ones it computes.

* ``prepare``: the evaluation's 24:-24 centre crop of every frame
  (``utils.py:768-769``), so 112x112 clips reach the net as 64x64;
* the backbone, on each frame: ``net_depth`` blocks of Conv2d k=3, padding
  1 (3 for a 1-channel input's first), GroupNorm with one group a channel
  (instance norm; flax's eps 1e-6, a scale and a bias a channel), ReLU,
  AvgPool 2x2; the features flattened in (H, W, C) order;
* the mean over the frames, then the Linear. No layer drops out.

θ is the JAX package's flat vector: the flax leaves sorted by their paths
(``ConvNet2D_0/GroupNorm_d/{bias, scale}``, then
``ConvNet2D_0/TorchConv_d/Conv_0/{bias, kernel}``, then
``TorchDense_0/Dense_0/{bias, kernel}``), conv kernels (H, W, in, out), the
dense kernel (in, out). A fresh net draws as the program's does: the
backbone's convs (weight then bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
layer by layer) twice, once as the backbone is built and once as the
whole net is, then the Linear's; the norms start at scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.ops import Quant, conv, split

CROP = 24       # pixels cut from each side of a frame for the evaluation
NORM_EPS = 1e-6


def _check(m: dict):
    want = {"net_norm": "instancenorm", "net_pooling": "avgpooling",
            "net_act": "relu"}
    wrong = {k: m.get(k) for k, v in want.items() if m.get(k, v) != v}
    if wrong:
        raise ValueError(f"VideoConvNetMean's reference computes {want}, "
                         f"not {wrong}")


def _size(m: dict) -> int:
    """The side of the frames the net sees."""
    return m["im_size"] - 2 * CROP


def _pad(m: dict, d: int) -> int:
    return 3 if m["channel"] == 1 and d == 0 else 1


def feat_dim(m: dict) -> int:
    """Features a frame: the last block's channels x its pooled area."""
    h = _size(m)
    for d in range(m["net_depth"]):
        h = (h + 2 * _pad(m, d) - 2) // 2
    return m["net_width"] * h * h


def _entries(m: dict) -> List[Tuple[Tuple[str, ...], str, Tuple[int, ...]]]:
    """(flax path, name, shape) of each leaf, in θ's order."""
    _check(m)
    w, out, cin = m["net_width"], [], m["channel"]
    for d in range(m["net_depth"]):
        norm, tconv = ("ConvNet2D_0", f"GroupNorm_{d}"), (
            "ConvNet2D_0", f"TorchConv_{d}", "Conv_0")
        out += [(norm + ("bias",), f"norm{d}.bias", (w,)),
                (norm + ("scale",), f"norm{d}.scale", (w,)),
                (tconv + ("bias",), f"conv{d}.bias", (w,)),
                (tconv + ("kernel",), f"conv{d}.kernel", (3, 3, cin, w))]
        cin = w
    k, dense = m["num_classes"], ("TorchDense_0", "Dense_0")
    out += [(dense + ("bias",), "head.bias", (k,)),
            (dense + ("kernel",), "head.kernel", (feat_dim(m), k))]
    return sorted(out)


def leaves(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each leaf of θ, in the flat vector's order."""
    return [(name, shape) for _, name, shape in _entries(m)]


def init_bounds(m: dict) -> List[float]:
    """Each leaf's init bound: 1/sqrt(fan_in) of a conv's or the Linear's
    weight and bias; 1 for a norm's scale and bias (which start at 1 and
    0)."""
    shapes = dict(leaves(m))
    out = []
    for name, _ in leaves(m):
        if name.startswith("norm"):
            out.append(1.0)
        else:
            kernel = shapes[name.rsplit(".", 1)[0] + ".kernel"]
            out.append(1.0 / math.sqrt(math.prod(kernel[:-1])))
    return out


def unflatten(theta: torch.Tensor, m: dict) -> Dict[str, torch.Tensor]:
    """θ -> {name: tensor}; conv kernels in torch's (out, in, H, W), the
    Linear's weight (out, in)."""
    out = {}
    for (name, shape), t in zip(leaves(m), split(theta, leaves(m)).values()):
        t = t.reshape(shape)
        if len(shape) == 4:
            t = t.permute(3, 2, 0, 1)
        elif len(shape) == 2:
            t = t.t()
        out[name] = t
    return out


def _uniform(shape, fan_in, generator, device) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape, device=device).uniform_(-bound, bound,
                                                      generator=generator)


def init_theta(generator: torch.Generator, m: dict, device) -> torch.Tensor:
    """A fresh net's θ, drawn from ``generator`` in the program's order."""
    w, drawn = m["net_width"], {}
    for _ in range(2):
        cin = m["channel"]
        for d in range(m["net_depth"]):
            weight = _uniform((w, cin, 3, 3), cin * 9, generator, device)
            drawn[f"conv{d}.kernel"] = weight.permute(2, 3, 1, 0)
            drawn[f"conv{d}.bias"] = _uniform((w,), cin * 9, generator, device)
            drawn[f"norm{d}.scale"] = torch.ones(w, device=device)
            drawn[f"norm{d}.bias"] = torch.zeros(w, device=device)
            cin = w
    d, k = feat_dim(m), m["num_classes"]
    drawn["head.kernel"] = _uniform((k, d), d, generator, device).t()
    drawn["head.bias"] = _uniform((k,), d, generator, device)
    return torch.cat([drawn[n].reshape(-1) for n, _ in leaves(m)])


def keep_mask_shape(m: dict) -> Optional[Tuple[int, ...]]:
    """None: no layer drops out, and no keep-mask is drawn."""
    return None


def prepare(x: torch.Tensor, m: dict) -> torch.Tensor:
    """The clips (..., H, W, C) as the evaluation gives them to the net:
    each frame's 24:-24 centre crop."""
    return x[..., CROP:-CROP, CROP:-CROP, :]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, m: dict,
            keep: Optional[torch.Tensor] = None, quant: Quant = None):
    """Logits of prepared clips x (B, F, H, W, C). ``keep`` is None: the net
    has no dropout."""
    if keep is not None:
        raise ValueError("VideoConvNetMean has no dropout")
    b, f = x.shape[:2]
    h = x.flatten(0, 1).permute(0, 3, 1, 2)
    for d in range(m["net_depth"]):
        h = conv(F.conv2d, h, params[f"conv{d}.kernel"],
                 params[f"conv{d}.bias"], quant, padding=_pad(m, d))
        h = F.group_norm(h, m["net_width"], params[f"norm{d}.scale"],
                         params[f"norm{d}.bias"], eps=NORM_EPS)
        h = F.avg_pool2d(F.relu(h), 2)
    feat = h.permute(0, 2, 3, 1).flatten(1).unflatten(0, (b, f)).mean(dim=1)
    return F.linear(feat, params["head.kernel"], params["head.bias"])
