"""Fused no-grad hallucinator composition: a Hopper kernel and its plain
version.

Port of ``video_distillation_tpu/ops/pallas/hallucinator_kernel.py``
(``hallucinate_fused``). It computes what ``ops.hal_conv``'s forward
computes, Conv3d(4 -> 3, k=3, pad=1) over [broadcast(static) | dynamic]
plus a bias, but forward only and in fp32: the evaluation path composes
its training batches from frozen memories and never differentiates them.

Layouts: static (B, H, W, 3), dynamic (B, F, H, W, 1), weight in torch's
Conv3d layout (3, 4, 3, 3, 3), bias (3,); all fp32, anything else raises
(casting is the caller's explicit ``.float()``). The kernel
(``csrc/hal_fused.cu``) writes y channel-planar, (B, 3, F, H, W);
``hal_fused`` returns it as a (B, F, H, W, 3) view, so ConvNet3D's move to
NCDHW finds a contiguous tensor.

``hal_fused`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors, and only for those, it computes
``hal_fused_plain``. Neither records an autograd graph. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .hal_conv import (_check_rc, _check_shapes, _check_weight, _flat_weights,
                       _on_cpu, _stream, hal_fwd_plain)

LAUNCHES = {"hal_fused": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches():
    LAUNCHES["hal_fused"] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("hal_fused")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hal_fused.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.hal_fused.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def hal_fused_plain(static, dynamic, weight, bias):
    """(B, F, H, W, 3) fp32: ``hal_fwd_plain`` (broadcast + concat + conv3d
    in fp32) without a graph, as a view of its channel-planar result."""
    with torch.no_grad():
        return hal_fwd_plain(static.float(), dynamic.float(), weight,
                             bias).permute(0, 2, 3, 4, 1)


def hal_fused(static, dynamic, weight, bias):
    """y = Conv3d([broadcast(static) | dynamic], weight, pad 1) + bias, fp32,
    as a (B, F, H, W, 3) view of channel-planar storage; no gradient."""
    _check_shapes(static, dynamic)
    _check_weight(weight, bias)
    for t in (static, dynamic, weight, bias):
        if t.dtype != torch.float32:
            raise TypeError(f"hal_fused takes fp32 inputs, got "
                            f"{[x.dtype for x in (static, dynamic, weight, bias)]}")
    if _on_cpu(static, dynamic, weight, bias):
        return hal_fused_plain(static, dynamic, weight, bias)
    if not (static.is_contiguous() and dynamic.is_contiguous()):
        raise ValueError("hal_fused: static and dynamic must be contiguous")
    b, frames, h, w, _ = dynamic.shape
    wb = _flat_weights(weight, bias)
    y = torch.empty(b, 3, frames, h, w, device=dynamic.device,
                    dtype=torch.float32)
    rc = _lib().hal_fused(static.data_ptr(), dynamic.data_ptr(), wb.data_ptr(),
                          y.data_ptr(), b, frames, h, w, _stream())
    _check_rc(rc, "hal_fused")
    LAUNCHES["hal_fused"] += 1
    return y.permute(0, 2, 3, 4, 1)
