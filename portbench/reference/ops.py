"""What every student net of the reference shares: a convolution in a lower
precision where the control asks for one, the masked cross entropy, and a
flat θ cut into its leaves (a net's ``leaves(m)``) or counted.

``quant``, where given, computes a convolution in a lower precision (the
control of ``correct``): ``quant.operand`` rounds its input and weight
(and their gradients), ``quant.result`` the gradient its output receives.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[object]


def conv(fn, x, w, b, quant: Quant = None, **kw):
    """``fn`` (``F.conv2d`` or ``F.conv3d``) of x by w, b."""
    if quant is None:
        return fn(x, w, b, **kw)
    return quant.result(fn(quant.operand(x), quant.operand(w), b, **kw))


def masked_ce(logits, y, w, denom):
    """Mean cross entropy over the rows of weight 1, divided by ``denom``."""
    logp = F.log_softmax(logits, dim=-1)
    return (-logp.gather(1, y[:, None])[:, 0] * w).sum() / denom


def split(theta: torch.Tensor, leaves: Sequence[Tuple[str, Tuple[int, ...]]]
          ) -> Dict[str, torch.Tensor]:
    """θ (..., P) -> {name: (..., n)}, the flat pieces of each leaf."""
    out, i = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        out[name] = theta[..., i:i + n]
        i += n
    return out


def num_params(leaves: Sequence[Tuple[str, Tuple[int, ...]]]) -> int:
    return sum(math.prod(s) for _, s in leaves)
