"""The s2d2 mover pair: Hopper kernels, plain versions, autograd.

Port of ``video_distillation_tpu/ops/pallas/s2d2_move.py``. ``pack`` turns
video (B, F, H, W, C) into the (B, F, H/2+4, W/2+4, 12C) view that
ConvNet3D's fused first stage convolves: a temporal im2col (frames f-1, f,
f+1) plus a 2x2 space-to-depth of the input zero-padded by 4, slot order
(py, px, dt, c), the JAX package's ``layers.s2d2_pack``. ``unpack_sum`` is
its exact linear transpose: every input element sits in three slots, so
the transpose is a 3-term frame-shifted sum. Two hand-written CUDA kernels
(``csrc/s2d2_move.cu``) compute them.

Each wrapper runs its kernel for CUDA tensors (float32 or bfloat16,
contiguous; anything else raises) and, for CPU tensors and only for those,
its plain version. ``LAUNCHES`` counts kernel launches per wrapper.

``Pack`` and ``Unpack`` are ``torch.autograd.Function``s that are each
other's backward, like the JAX primitives' transposes. Both maps are
linear, so this closes them under any order of differentiation: the MTT
unroll's second-order pass differentiates ``Pack``'s backward (an
``Unpack``) once more. Neither may be ``once_differentiable``. Each has a
``torch.func.vmap`` rule that folds the nets into the batch axis and
launches its kernel once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .hal_conv import (_DTYPE_CODE, _check_cuda_inputs, _check_rc, _on_cpu,
                       _stream)

LAUNCHES = {"s2d2_pack": 0, "s2d2_unpack": 0}

_MAX_GRID_Y = 65535
_LIB: Optional[ctypes.CDLL] = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("s2d2_move")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.s2d2_pack, lib.s2d2_unpack):
            fn.argtypes = [i, p, p, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def packed_hw(h: int, w: int):
    return h // 2 + 4, w // 2 + 4


def _check_cuda(name, t, b, f, per_frame):
    _check_cuda_inputs(name, t)
    if b * f > _MAX_GRID_Y or per_frame >= 2 ** 31:
        raise ValueError(f"{name}: B*F={b * f} or {per_frame} elements a "
                         "frame exceed the kernel's grid")


def _check_video(x):
    if x.dim() != 5 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"pack: x must be (B, F, H, W, C) with H, W even, "
                         f"got {tuple(x.shape)}")


def _check_packed(g, h, w):
    hc, wc = packed_hw(h, w)
    if (g.dim() != 5 or tuple(g.shape[2:4]) != (hc, wc) or g.shape[4] % 12
            or h % 2 or w % 2):
        raise ValueError(f"unpack_sum: g must be (B, F, {hc}, {wc}, 12C) for "
                         f"H, W = {h}, {w} (even), got {tuple(g.shape)}")


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def pack_plain(x):
    """The JAX package's "xla" chain (``layers.py:582-605``): pad frames,
    stack t-1/t/t+1 on channels, pad space by 4, 2x2 space-to-depth."""
    b, f, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    xs = torch.cat([xp[:, 0:f], xp[:, 1:f + 1], xp[:, 2:f + 2]], dim=-1)
    xpad = F.pad(xs.reshape(b * f, h, w, 3 * c), (0, 0, 4, 4, 4, 4))
    hc, wc = packed_hw(h, w)
    return (xpad.reshape(b * f, hc, 2, wc, 2, 3 * c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, f, hc, wc, 12 * c))


def unpack_plain(g, h: int, w: int):
    """pack's transpose written out: undo the space-to-depth, crop the pad,
    and add each temporal slot into the frame it read, in fp32 (fp64 for
    fp64) and in the kernel's order (dt = 0, 1, 2), rounded once to g's dtype."""
    b, f, hc, wc, k = g.shape
    c = k // 12
    acc = torch.promote_types(g.dtype, torch.float32)
    planes = (g.to(acc).reshape(b, f, hc, wc, 2, 2, 3, c)
              .permute(0, 1, 2, 4, 3, 5, 6, 7).reshape(b, f, 2 * hc, 2 * wc, 3, c)
              [:, :, 4:4 + h, 4:4 + w])
    # slot dt of packed frame f read input frame f + dt - 1
    out = torch.zeros(b, f, h, w, c, device=g.device, dtype=acc)
    out[:, :-1] += planes[:, 1:, :, :, 0, :]
    out += planes[..., 1, :]
    out[:, 1:] += planes[:, :-1, :, :, 2, :]
    return out.to(g.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def pack(x):
    """(B, F, H, W, C) -> (B, F, H/2+4, W/2+4, 12C) in x's dtype."""
    _check_video(x)
    if _on_cpu(x):
        return pack_plain(x)
    b, f, h, w, c = x.shape
    hc, wc = packed_hw(h, w)
    _check_cuda("pack", x, b, f, hc * wc * 12 * c)
    out = torch.empty(b, f, hc, wc, 12 * c, device=x.device, dtype=x.dtype)
    rc = _lib().s2d2_pack(_DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                          b, f, h, w, c, _stream())
    _check_rc(rc, "s2d2_pack")
    LAUNCHES["s2d2_pack"] += 1
    return out


def unpack_sum(g, h: int, w: int):
    """pack's transpose: (B, F, H/2+4, W/2+4, 12C) -> (B, F, H, W, C), the
    three slots of each element summed in fp32 and rounded once."""
    _check_packed(g, h, w)
    if _on_cpu(g):
        return unpack_plain(g, h, w)
    b, f, _, _, k = g.shape
    c = k // 12
    _check_cuda("unpack_sum", g, b, f, h * w * c)
    out = torch.empty(b, f, h, w, c, device=g.device, dtype=g.dtype)
    rc = _lib().s2d2_unpack(_DTYPE_CODE[g.dtype], g.data_ptr(), out.data_ptr(),
                            b, f, h, w, c, _stream())
    _check_rc(rc, "s2d2_unpack")
    LAUNCHES["s2d2_unpack"] += 1
    return out


# vmap rules (s2d2_move.py:200-212): (V, B, ...) folds to (V*B, ...), one
# call of the unbatched Function, and the result unfolds.

def _fold_batch(t, d):
    t = t.movedim(d, 0)
    return t.flatten(0, 1).contiguous(), t.shape[:2]


class Pack(torch.autograd.Function):
    """xv = pack(x); backward = Unpack (twice differentiable)."""

    @staticmethod
    def forward(x):
        return pack(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hw = tuple(inputs[0].shape[2:4])

    @staticmethod
    def backward(ctx, g):
        return Unpack.apply(g.contiguous(), *ctx.hw)

    @staticmethod
    def vmap(info, in_dims, x):
        x, vb = _fold_batch(x, in_dims[0])
        return Pack.apply(x).unflatten(0, vb), 0


class Unpack(torch.autograd.Function):
    """x̄ = unpack_sum(ḡ); backward = Pack (twice differentiable)."""

    @staticmethod
    def forward(g, h, w):
        return unpack_sum(g, h, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gx):
        return Pack.apply(gx.contiguous()), None, None

    @staticmethod
    def vmap(info, in_dims, g, h, w):
        g, vb = _fold_batch(g, in_dims[0])
        return Unpack.apply(g, h, w).unflatten(0, vb), 0


def s2d2_pack(x):
    """Differentiable ``pack`` of (B, F, H, W, C) video."""
    return Pack.apply(x.contiguous())
