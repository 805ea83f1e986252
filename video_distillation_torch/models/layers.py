"""Building blocks of the port's models: init bounds, activations, pools,
norms, the fp32 stage island, and the fused s2d2 first stage.

Port of the matching parts of ``video_distillation_tpu/models/layers.py``.
Tensors here are channels-first (NCHW, NCDHW: torch's own layout); the
models permute at their public boundary.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.phase_trio import phase_max
from ..ops.s2d2_move import s2d2_pack
from ..utils.profiling import to_device


def torch_default_bound(fan_in: int) -> float:
    """Torch's default Conv/Linear init draws weights and biases from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (layers.py:23-47)."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


@torch.no_grad()
def init_conv_(conv: nn.Module, generator: Optional[torch.Generator] = None):
    """Torch-default init of a Conv2d's, Conv3d's or Linear's weight and
    bias from an explicit generator (the JAX package's ``TorchConv`` and
    ``TorchDense``, layers.py:369, :733). fan_in = in_channels *
    prod(kernel_size), or in_features."""
    w = conv.weight
    bound = torch_default_bound(w.shape[1] * math.prod(w.shape[2:]))
    w.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def activation(name: str):
    if name == "sigmoid":
        return torch.sigmoid
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    if name == "swish":
        # reference Swish is x * sigmoid(x) (networks.py:12-18)
        return F.silu
    raise ValueError(f"unknown activation function: {name}")


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def max_pool(x, window: Sequence[int], strides: Optional[Sequence[int]] = None):
    """VALID max-pool over the spatial dims of channels-first x, (H, W) or
    (D, H, W) by the window's length (floor output size, as torch and the
    JAX package both give)."""
    return _MAX_POOL[len(window)](x, tuple(window),
                                  stride=tuple(strides or window))


def avg_pool(x, window: Sequence[int], strides: Optional[Sequence[int]] = None):
    return _AVG_POOL[len(window)](x, tuple(window),
                                  stride=tuple(strides or window))


# flax's GroupNorm and LayerNorm epsilon (torch's default is 1e-5)
NORM_EPS = 1e-6


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` through ``torch.native_group_norm``, the op
    ``F.group_norm`` reaches (the same result and derivatives), called
    directly because ``F.group_norm``'s memory-format query has no vmap
    rule (batched evaluation vmaps the 2-D ConvNets)."""

    def forward(self, x):
        n, c = x.shape[:2]
        return torch.native_group_norm(x.contiguous(), self.weight, self.bias,
                                       n, c, math.prod(x.shape[2:]),
                                       self.num_groups, self.eps)[0]


# flax's BatchNorm epsilon
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over channels-first x (the statistics over every
    axis but the channel). Train mode normalises with the batch statistics
    and updates the running ones in place; eval mode normalises with the
    running ones. The batch variance is flax's ``E[x^2] - E[x]^2`` clipped
    at 0, biased (torch's ``BatchNorm2d`` keeps the unbiased one), and the
    update is flax's ``ra = momentum ra + (1 - momentum) batch`` (torch's
    ``momentum`` weighs the other side). ``weight`` and ``bias`` are flax's
    ``scale`` and ``bias``; ``running_mean`` and ``running_var`` its
    ``batch_stats`` ``mean`` and ``var``, buffers outside the flat
    parameter vector."""

    def __init__(self, channels: int, momentum: float, eps: float = BN_EPS,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self):
        """A fresh layer: scale 1, bias 0, running mean 0 and variance 1."""
        for t, v in ((self.weight, 1.0), (self.bias, 0.0),
                     (self.running_mean, 0.0), (self.running_var, 1.0)):
            t.fill_(v)

    def forward(self, x, train: bool = True):
        view = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(view)) * mul.view(view) + self.bias.view(view)


def apply_norm(norm: Optional[nn.Module], x, train: bool):
    """``norm(x)``, with the train flag for a BatchNorm; x for None."""
    if norm is None:
        return x
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


def norm_layer(net_norm: str, channels: int, device=None) -> Optional[nn.Module]:
    """The reference's norm names as torch modules (``layers.py:796-819``);
    None for 'none'. 'instancenorm' is GroupNorm(C groups) and 'groupnorm'
    GroupNorm(4) (networks.py:778-790); the JAX 'layernorm' normalises over
    (H, W, C) with one scale and bias per channel, which is GroupNorm(1).
    Each keeps one weight (flax's ``scale``) and bias per channel.
    'batchnorm' is flax's BatchNorm at momentum 0.9 (the DC nets')."""
    groups = {"instancenorm": channels, "groupnorm": 4, "layernorm": 1}
    if net_norm == "none":
        return None
    if net_norm in groups:
        return GroupNorm(groups[net_norm], channels, eps=NORM_EPS,
                         device=device)
    if net_norm == "batchnorm":
        return BatchNorm(channels, momentum=0.9, device=device)
    raise ValueError(f"unknown net_norm: {net_norm}")


KNOWN_STAGES = frozenset({"s1", "s2", "s3", "head"})


def check_stages(stages: Sequence[str]) -> tuple:
    unknown = set(stages) - KNOWN_STAGES
    if unknown:
        raise ValueError(f"unknown fp32 island stage(s) {sorted(unknown)}; "
                         f"known: {sorted(KNOWN_STAGES)}")
    return tuple(stages)


def stage_island(x, name: str, base_dtype, fp32_stages: Sequence[str] = ()):
    """Cast x for stage ``name``: fp32 inside an island, the caller's compute
    dtype outside (layers.py:128-155). A cast's backward is a cast, so the
    island holds in every derivative of the forward too."""
    want = torch.float32 if name in fp32_stages else base_dtype
    return x if x.dtype == want else x.to(want)


# The fused first stage (``layers.py:573-643``): Conv3d k=(3,7,7) stride
# (1,2,2) pad (1,3,3) followed by the (1,2,2) max-pool, as ONE stride-2 5x5
# 2-D conv over the s2d2-packed input whose 4*O output channels are the four
# pool phases, then the phase max and the bias (per channel, so it commutes
# with the max; added after it, as the JAX package does).
#
# Pool output (i, j) at phase a taps input rows 4i + 2a - 3 + u (u in
# [0, 7)); with the +4 pad, packed cell c covers rows 2c-4 and 2c-3, so tap u
# lands in relative cell d = (2a+1+u)//2 (window 5, stride 2), sub-row
# p = (2a+1+u) % 2. _U2[d, p, a] inverts that: u = 2d + p - 2a - 1, or 7 (a
# zero slot) where out of range.
_U2 = np.full((5, 2, 2), 7, np.int64)
for _d in range(5):
    for _p in range(2):
        for _a in range(2):
            _u = 2 * _d + _p - 2 * _a - 1
            if 0 <= _u <= 6:
                _U2[_d, _p, _a] = _u


def s2d2_weight(weight):
    """Conv3d weight (O, C, 3, 7, 7) -> the packed 2-D kernel (4O, 12C, 5, 5)
    in channels-last storage: input channels (py, px, dt, c), output
    channels (ay, ax, o). A gather (``layers.py:608-622``), so it stays
    differentiable to any order; laid out channels-last by its permute
    (``contiguous(memory_format=...)`` has no vmap rule)."""
    o, c = weight.shape[:2]
    # (O, C, kt, kh, kw) -> the JAX package's w2 (kh, kw, kt*C + c, O),
    # zero-padded by one tap in kh and kw for the empty slot 7
    w2 = weight.permute(3, 4, 2, 1, 0).reshape(7, 7, 3 * c, o)
    w2p = F.pad(w2, (0, 0, 0, 0, 0, 1, 0, 1))
    u = to_device(_U2, weight.device)
    wg = w2p[u[:, :, :, None, None, None], u[None, None, None]]
    # (dy, py, ay, dx, px, ax, ck, o) -> (ay, ax, o, dy, dx, py, px, ck),
    # then viewed as (4O, 12C, 5, 5)
    return (wg.permute(2, 5, 7, 0, 3, 1, 4, 6).reshape(4 * o, 5, 5, 12 * c)
            .permute(0, 3, 1, 2))


def s2d2_conv_pool(x, weight, bias):
    """Video (B, F, H, W, C), H and W divisible by 4 -> NCDHW
    (B, O, F, H/4, W/4): conv + (1,2,2) max-pool + bias, without the
    activation. The packed view goes to cuDNN as a channels-last NCHW
    tensor, so its (BF, Ho, Wo, 4O) output is already the (rows, 4O) layout
    the phase max reads; the max writes NCDHW directly."""
    b, f, h, w, c = x.shape
    o = weight.shape[0]
    xv = s2d2_pack(x).view(b * f, h // 2 + 4, w // 2 + 4, 12 * c)
    y = F.conv2d(xv.permute(0, 3, 1, 2), s2d2_weight(weight), stride=2)
    ho, wo = y.shape[2:]
    m = phase_max(y.permute(0, 2, 3, 1).reshape(-1, 4 * o), f * ho * wo)
    return m.view(b, o, f, ho, wo) + bias.view(1, o, 1, 1, 1)


class ImageModel(nn.Module):
    """What the image nets share (the port of the JAX package's image zoo,
    each a flax module over ``(B, H, W, C)``).

    * ``image_input``: NHWC -> NCHW. A ``(B, 1, H, W, C)`` input (the raw
      DM and MTT drivers' synthetic set on an image store,
      ``dm.init_synthetic_raw``) is taken as its images where the JAX net
      computes the same function on it (its leading axes are batch axes to
      flax's convs and pools), and raises where it does not: the JAX
      package's pairwise max-pool halves that frame axis to size 0, so a
      net with a max-pool (``max_pools``) sees no features (ROADMAP C.18).
    * ``heads``: the ``output`` modes 'logits', 'feat' and 'both' over the
      features, flattened in the JAX (H, W, C) order by ``nhwc_flatten``.
    * ``jax_tree``: the flax tree of the net as (path prefix, torch module
      name, kind) triples, kind one of 'torchconv', 'torchdense' (the JAX
      ``TorchConv``/``TorchDense``, whose leaves sit under ``Conv_0`` /
      ``Dense_0``), 'conv', 'dense' (flax's own) and 'norm'
      (``scale``/``bias``; a BatchNorm's ``mean``/``var`` go to its
      ``batch_stats``). ``distill/params.py`` makes the layout of it.
    * ``reset_parameters``: torch-default convs and linears from the
      generator (the JAX ``TorchConv``/``TorchDense`` init), norms at scale
      1 and bias 0 (and a BatchNorm's statistics at 0 and 1).
    """

    max_pools = False

    def __init__(self):
        super().__init__()
        self.jax_tree = []
        self._widest = {}

    def image_input(self, x):
        if x.dim() == 5:
            if x.shape[1] != 1:
                raise ValueError(f"{type(self).__name__} takes images; got "
                                 f"clips of shape {tuple(x.shape)}")
            if self.max_pools:
                raise ValueError(
                    f"{type(self).__name__} has a max-pool, which the JAX "
                    "package runs over the singleton frame axis of a "
                    "(B, 1, H, W, C) input, leaving no features: the raw DM "
                    "and MTT drivers give an image store's synthetic set "
                    "that axis, and the JAX package fails on it (ROADMAP "
                    "C.18)")
            x = x[:, 0]
        return x.permute(0, 3, 1, 2)

    def heads(self, feat, output: str):
        if output == "feat":
            return feat
        logits = self.head(feat)
        if output == "both":
            return logits, feat
        return logits

    def clip_elements(self, frames: int, h: int, w: int) -> int:
        """Elements of the widest activation ``frames`` (h, w) images make
        (``net_groups`` and ``dm.real_chunk`` size their batches by it):
        the largest input or output of a submodule in one eval-mode forward
        of an (h, w) image, on the meta device (once a size: about 0.15 s
        for ResNet18)."""
        if (h, w) in self._widest:
            return frames * self._widest[h, w]
        first = next(m for m in self.modules()
                     if isinstance(m, (nn.Conv2d, nn.Linear)))
        channel = (first.in_channels if isinstance(first, nn.Conv2d)
                   else first.in_features // (h * w))
        widest = 0

        def hook(_, args, out):
            nonlocal widest
            for t in (*args, out):
                if isinstance(t, torch.Tensor):
                    widest = max(widest, t.numel())

        handles = [m.register_forward_hook(hook) for m in self.modules()]
        try:
            meta = {k: torch.empty_like(t, device="meta") for k, t in
                    (*self.named_parameters(), *self.named_buffers())}
            torch.func.functional_call(
                self, meta, (torch.empty(1, h, w, channel, device="meta"),),
                dict(train=False, output="feat"))
        finally:
            for handle in handles:
                handle.remove()
        self._widest[h, w] = widest
        return frames * widest

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init_conv_(m, generator)
            elif isinstance(m, (nn.GroupNorm, BatchNorm, ChannelLayerNorm)):
                m.reset_parameters()


def nhwc_flatten(x):
    """NCHW features flattened in the JAX (H, W, C) order."""
    return x.permute(0, 2, 3, 1).flatten(1)


class ChannelLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm()`` over NCHW x: each pixel normalised over its
    channels (flax's default reduction, the last axis of NHWC), epsilon
    1e-6."""

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=NORM_EPS, device=device)

    def forward(self, x):
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)
