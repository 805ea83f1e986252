"""ConvNet3D's later-stage convolution on the tensor cores: Hopper kernel,
plain version, autograd.

ConvNet3D's stages after the first are Conv3d(k (3,7,7), stride (1,2,2),
pad (1,3,3)). In bf16 on the card, cuDNN's heuristic ran the second stage's
forward on an FFMA implicit GEMM without tensor cores, more than half of an
S2D-MTT outer step. ``csrc/conv3d_s2.cu`` computes that forward on the
tensor cores (bf16 in, fp32 sums, bf16 out, NCDHW in and out, the bias
added to the fp32 sums); it replaces no kernel of the JAX package, which
leaves this convolution to XLA.

``Conv3dS2`` runs the kernel in the forward and in every forward
convolution of the second-order pass, which the MTT unroll's
``create_graph`` makes:

* ``Conv3dS2``: y = conv(x, W) + b; backward ``Conv3dS2Dgrad(gO, W)``,
  ``Conv3dS2Wgrad(x, gO)`` and the bias's sum;
* ``Conv3dS2Dgrad``: cuDNN's input gradient (``aten.convolution_backward``
  with the input mask alone); backward ``Conv3dS2(ggI, W)`` for gO and
  ``Conv3dS2Wgrad(ggI, gO)`` for W;
* ``Conv3dS2Wgrad``: cuDNN's weight gradient; backward ``Conv3dS2(x, ggW)``
  for gO and ``Conv3dS2Dgrad(gO, ggW)`` for x.

None is ``once_differentiable``. Each saves what ``F.conv3d``'s autograd
saves (x, W, gO), and the kernel takes no workspace. ``fprop`` launches the
kernel for CUDA tensors and raises on what it does not take; for CPU
tensors, and only for those, it computes the plain version (``F.conv3d``).
``LAUNCHES`` counts kernel launches. ``routes`` is the gate ConvNet3D
reads: bf16 on the card, channels multiples of 16, a GEMM of M >= MIN_M
output positions.

vmap: a mapped weight or bias raises, as ``HalConv``'s rule does; a mapped
input folds the nets into the batch (one launch), and the weight gradient
is taken net by net, so each net's sums stay apart.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .hal_conv import _check_rc, _on_cpu, _stream

LAUNCHES = {"conv3d_s2_fprop": 0}

KERNEL, STRIDE, PADDING, DILATION = (3, 7, 7), (1, 2, 2), (1, 3, 3), (1, 1, 1)
COUT_TILE = 128  # output channels a block of the kernel
_MAX_WO = 256  # the kernel's widest output row
# the least GEMM M (output positions, B*F*Ho*Wo) routed to the kernel, from
# chip_smoke.py's crossover (H100 80GB HBM3, 700 W): from M = 16,384 up the
# kernel ran 1.6-8.5x faster than cuDNN at every size tried; under it cuDNN's
# tensor-core kernels won at the third stage's 7x7 rows (M 3,200-12,800,
# both cells' third stages among them: 0.23-0.25 ms against 0.37-0.96) and
# at 28x28 rows of M 3,136 and 6,272
MIN_M = 16384
_LIB: Optional[ctypes.CDLL] = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("conv3d_s2")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3d_s2_fprop.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.conv3d_s2_fprop.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def out_size(n: int) -> int:
    """Output length of a k-7, stride-2, pad-3 axis."""
    return (n - 1) // 2 + 1


def gemm_m(shape) -> int:
    """Output positions of a (B, Cin, F, H, W) input: the GEMM's M."""
    b, _, frames, h, w = shape
    return b * frames * out_size(h) * out_size(w)


def routes(x, weight) -> bool:
    """Whether ConvNet3D's convolution of x by weight takes the kernel: bf16
    on the card, the (3,7,7) kernel, channels multiples of 16, an output
    row the kernel takes and M >= MIN_M. fp32 (evaluation, DM, every fp32
    path) keeps cuDNN."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and weight.dtype == torch.bfloat16 and x.dim() == 5
            and tuple(weight.shape[2:]) == KERNEL
            and x.shape[1] % 16 == 0 and weight.shape[0] % 16 == 0
            and out_size(x.shape[4]) <= _MAX_WO and gemm_m(x.shape) >= MIN_M
            and math.prod(x.shape) < 2 ** 31)


def _check_shapes(x, weight, bias):
    if x.dim() != 5 or weight.dim() != 5 or tuple(weight.shape[2:]) != KERNEL:
        raise ValueError(f"conv3d_s2: x must be (B, Cin, F, H, W) and weight "
                         f"(Cout, Cin, 3, 7, 7), got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    if weight.shape[1] != x.shape[1]:
        raise ValueError(f"conv3d_s2: weight takes {weight.shape[1]} input "
                         f"channels, x has {x.shape[1]}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"conv3d_s2: bias must be ({weight.shape[0]},), got "
                         f"{tuple(bias.shape)}")


def _check_cuda(x, weight, bias):
    for t in (x, weight) + (() if bias is None else (bias,)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv3d_s2: the kernel takes bfloat16, got {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3d_s2: x must be contiguous")
    if x.shape[1] % 4:
        raise ValueError(f"conv3d_s2: {x.shape[1]} input channels, not a "
                         "multiple of 4")
    if out_size(x.shape[4]) > _MAX_WO:
        raise ValueError(f"conv3d_s2: output rows of {out_size(x.shape[4])} "
                         f"exceed the kernel's {_MAX_WO}")
    if x.numel() >= 2 ** 31:
        raise ValueError("conv3d_s2: x has 2^31 elements or more (the kernel "
                         "offsets it in 32 bits)")


def prep_weight(weight):
    """The kernel's weight layout: (ceil(Cout/128), 3, Cin, 7, 128, 8), each
    (ci, kh) row of 8 taps a zero, then kw 0-6; channels past Cout zero."""
    cout, cin = weight.shape[:2]
    nb = -(-cout // COUT_TILE)
    w = F.pad(weight, (1, 0, 0, 0, 0, 0, 0, 0, 0, nb * COUT_TILE - cout))
    return w.view(nb, COUT_TILE, cin, 3, 7, 8).permute(0, 3, 2, 4, 1, 5).contiguous()


# ---------------------------------------------------------------------------
# plain versions and the kernel's wrapper
# ---------------------------------------------------------------------------

def fprop_plain(x, weight, bias=None):
    return F.conv3d(x, weight, bias, stride=STRIDE, padding=PADDING)


def fprop(x, weight, bias=None):
    """y = conv3d(x, weight) + bias, (B, Cout, F, Ho, Wo): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_shapes(x, weight, bias)
    if _on_cpu(x, weight, *(() if bias is None else (bias,))):
        return fprop_plain(x, weight, bias)
    _check_cuda(x, weight, bias)
    b, cin, frames, h, w = x.shape
    cout = weight.shape[0]
    y = torch.empty(b, cout, frames, out_size(h), out_size(w), device=x.device,
                    dtype=x.dtype)
    wp = prep_weight(weight)
    bias = None if bias is None else bias.contiguous()
    rc = _lib().conv3d_s2_fprop(x.data_ptr(), wp.data_ptr(),
                                None if bias is None else bias.data_ptr(),
                                y.data_ptr(), b, cin, cout, frames, h, w,
                                _stream())
    _check_rc(rc, "conv3d_s2_fprop")
    LAUNCHES["conv3d_s2_fprop"] += 1
    return y


def _conv_backward(g, x, weight, mask):
    """cuDNN's input or weight gradient (``mask``), as autograd computes
    them for ``F.conv3d``."""
    return torch.ops.aten.convolution_backward(
        g, x, weight, None, STRIDE, PADDING, DILATION, False, (0, 0, 0), 1,
        mask)


# ---------------------------------------------------------------------------
# autograd and vmap
# ---------------------------------------------------------------------------

def _no_mapped_weight(name, *dims):
    if any(d is not None for d in dims):
        raise NotImplementedError(
            f"{name}: vmap over the weight or bias is not supported; per-net "
            "weights take F.conv3d")


class Conv3dS2(torch.autograd.Function):
    """y = fprop(x, W, b); backward Conv3dS2Dgrad, Conv3dS2Wgrad and the
    bias's sum."""

    @staticmethod
    def forward(x, weight, bias):
        return fprop(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _ = inputs
        ctx.save_for_backward(x, weight)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g = g.contiguous()
        return (Conv3dS2Dgrad.apply(g, weight, x) if need_x else None,
                Conv3dS2Wgrad.apply(x, g, weight) if need_w else None,
                g.sum((0, 2, 3, 4)) if need_b else None)

    @staticmethod
    def vmap(info, in_dims, x, weight, bias):
        _no_mapped_weight("conv3d_s2", in_dims[1], in_dims[2])
        x = x.movedim(in_dims[0], 0)
        y = Conv3dS2.apply(x.flatten(0, 1).contiguous(), weight, bias)
        return y.unflatten(0, x.shape[:2]), 0


class Conv3dS2Dgrad(torch.autograd.Function):
    """dx = dgrad(gO, W) in the layout of x_like, which gives the shape only
    (no gradient flows to it); linear in gO and W."""

    @staticmethod
    def forward(g, weight, x_like):
        return _conv_backward(g, x_like, weight, (True, False, False))[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, weight, _ = inputs
        ctx.save_for_backward(g, weight)

    @staticmethod
    def backward(ctx, ggx):
        g, weight = ctx.saved_tensors
        need_g, need_w, _ = ctx.needs_input_grad
        ggx = ggx.contiguous()
        return (Conv3dS2.apply(ggx, weight, None) if need_g else None,
                Conv3dS2Wgrad.apply(ggx, g, weight) if need_w else None,
                None)

    @staticmethod
    def vmap(info, in_dims, g, weight, x_like):
        _no_mapped_weight("conv3d_s2 dgrad", in_dims[1])
        g = g.movedim(in_dims[0], 0)
        x_like = (x_like.movedim(in_dims[2], 0) if in_dims[2] is not None
                  else x_like.expand(info.batch_size, *x_like.shape))
        dx = Conv3dS2Dgrad.apply(g.flatten(0, 1).contiguous(), weight,
                                 x_like.flatten(0, 1))
        return dx.unflatten(0, g.shape[:2]), 0


class Conv3dS2Wgrad(torch.autograd.Function):
    """dW = wgrad(x, gO) in w_like's shape (no gradient flows to w_like);
    linear in x and gO."""

    @staticmethod
    def forward(x, g, w_like):
        return _conv_backward(g, x, w_like, (False, True, False))[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, g, _ = inputs
        ctx.save_for_backward(x, g)

    @staticmethod
    def backward(ctx, ggw):
        x, g = ctx.saved_tensors
        need_x, need_g, _ = ctx.needs_input_grad
        ggw = ggw.contiguous()
        return (Conv3dS2Dgrad.apply(g, ggw, x) if need_x else None,
                Conv3dS2.apply(x, ggw, None) if need_g else None,
                None)

    @staticmethod
    def vmap(info, in_dims, x, g, w_like):
        _no_mapped_weight("conv3d_s2 wgrad", in_dims[2])
        x, g = (t.movedim(d, 0) if d is not None
                else t.expand(info.batch_size, *t.shape)
                for t, d in zip((x, g), in_dims[:2]))
        return torch.stack([Conv3dS2Wgrad.apply(x[v], g[v], w_like)
                            for v in range(info.batch_size)]), 0


def conv3d_s2(x, weight, bias=None):
    """Differentiable conv3d(x, weight, bias, stride (1,2,2), pad (1,3,3))
    with the (3,7,7) kernel, NCDHW."""
    return Conv3dS2.apply(x.contiguous(), weight, bias)
