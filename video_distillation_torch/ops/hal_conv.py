"""Hallucinator composition conv: Hopper kernels, plain version, autograd.

Port of ``video_distillation_tpu/ops/pallas/hal_vjp.py``. The composition is
Conv3d(4 -> 3, k=3, pad=1) over [broadcast(static) | dynamic] plus a bias.
Three hand-written CUDA kernels (``csrc/hal_conv.cu``) compute it:

* ``hal_fwd``: y from (static, dynamic, weight, bias);
* ``hal_dgrad``: the static and/or dynamic cotangents from ȳ;
* ``hal_wgrad``: the weight and bias cotangents from (ȳ, static, dynamic).

Layouts: static (B, H, W, 3), dynamic (B, F, H, W, 1), weight in torch's
Conv3d layout (3, 4, 3, 3, 3) (input channels: RGB static, then dynamic),
bias (3,). The kernels write y channel-planar, (B, 3, F, H, W); ``hal_conv``
returns it as a (B, F, H, W, 3) view, so a consumer that moves to NCDHW
gets a contiguous tensor without a copy.

Each wrapper runs its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors, and only for those, it computes the
plain version (naive broadcast + concat + ``F.conv3d``, gradients by
autograd). ``LAUNCHES`` counts kernel launches per wrapper.

``HalConv`` wires the three together as a ``torch.autograd.Function``. It
has no double backward: the hallucinator sits outside the MTT inner
unroll, so its outputs are only ever differentiated once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import build

LAUNCHES = {"hal_fwd": 0, "hal_dgrad": 0, "hal_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WGRAD_PIXELS_PER_BLOCK = 4096
_LIB: Optional[ctypes.CDLL] = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("hal_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hal_fwd.argtypes = [i, p, p, p, p, i, i, i, i, p]
        lib.hal_dgrad.argtypes = [i, p, p, p, p, i, i, i, i, p]
        lib.hal_wgrad.argtypes = [i, p, p, p, p, i, p, i, i, i, i, p]
        for fn in (lib.hal_fwd, lib.hal_dgrad, lib.hal_wgrad):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_rc(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"hal_conv: tensors must share one CUDA device or "
                         f"all be on the CPU, got {[t.device for t in tensors]}")
    return False


def _check_cuda_inputs(name: str, *tensors):
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dt} not supported "
                        "(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_shapes(static, dynamic):
    if dynamic.dim() != 5 or dynamic.shape[-1] != 1:
        raise ValueError(f"dynamic must be (B, F, H, W, 1), got {tuple(dynamic.shape)}")
    b, _, h, w, _ = dynamic.shape
    if tuple(static.shape) != (b, h, w, 3):
        raise ValueError(f"static must be (B, H, W, 3) = {(b, h, w, 3)}, "
                         f"got {tuple(static.shape)}")
    if b > 65535:
        raise ValueError(f"hal_conv: batch {b} exceeds the kernel grid limit 65535")


def _check_weight(weight, bias):
    if tuple(weight.shape) != (3, 4, 3, 3, 3) or tuple(bias.shape) != (3,):
        raise ValueError(f"weight must be (3, 4, 3, 3, 3) and bias (3,), got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")


def _flat_weights(weight, bias):
    """fp32 (327,): the kernel in (kt, kh, kw, ci, co) order, then the bias."""
    return torch.cat([weight.detach().permute(2, 3, 4, 1, 0).reshape(-1).float(),
                      bias.detach().reshape(-1).float()]).contiguous()


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def hal_fwd_plain(static, dynamic, weight, bias):
    """Planar y (B, 3, F, H, W): naive broadcast + concat + conv3d in fp32,
    cast to the dynamic input's dtype."""
    b, frames, h, w, _ = dynamic.shape
    s = static.float().permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, frames, h, w)
    x = torch.cat([s, dynamic.float().permute(0, 4, 1, 2, 3)], dim=1)
    y = F.conv3d(x, weight.float(), bias.float(), padding=1)
    return y.to(dynamic.dtype)


def hal_dgrad_plain(g, weight, need_s: bool = True, need_d: bool = True):
    """(ds (B,H,W,3) | None, dd (B,F,H,W,1) | None) in ȳ's dtype, by autograd
    of the plain forward (linear in static and dynamic)."""
    b, _, frames, h, w = g.shape
    with torch.enable_grad():
        s = torch.zeros(b, h, w, 3, device=g.device, requires_grad=True)
        d = torch.zeros(b, frames, h, w, 1, device=g.device, requires_grad=True)
        y = hal_fwd_plain(s, d, weight.detach().float(),
                          torch.zeros(3, device=g.device))
        ds, dd = torch.autograd.grad(y, (s, d), g.float())
    return (ds.to(g.dtype) if need_s else None,
            dd.to(g.dtype) if need_d else None)


def hal_wgrad_plain(g, static, dynamic):
    """(dweight (3,4,3,3,3), dbias (3,)) in fp32, by autograd of the plain
    forward (linear in weight and bias)."""
    with torch.enable_grad():
        wt = torch.zeros(3, 4, 3, 3, 3, device=g.device, requires_grad=True)
        bs = torch.zeros(3, device=g.device, requires_grad=True)
        y = hal_fwd_plain(static.float(), dynamic.float(), wt, bs)
        dw, db = torch.autograd.grad(y, (wt, bs), g.float())
    return dw, db


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def hal_fwd(static, dynamic, weight, bias):
    """Planar y (B, 3, F, H, W) in the dynamic input's dtype."""
    _check_shapes(static, dynamic)
    _check_weight(weight, bias)
    if _on_cpu(static, dynamic, weight, bias):
        return hal_fwd_plain(static, dynamic, weight, bias)
    _check_cuda_inputs("hal_fwd", static, dynamic)
    b, frames, h, w, _ = dynamic.shape
    wb = _flat_weights(weight, bias)
    y = torch.empty(b, 3, frames, h, w, device=dynamic.device, dtype=dynamic.dtype)
    rc = _lib().hal_fwd(_DTYPE_CODE[dynamic.dtype], static.data_ptr(),
                        dynamic.data_ptr(), wb.data_ptr(), y.data_ptr(),
                        b, frames, h, w, _stream())
    _check_rc(rc, "hal_fwd")
    LAUNCHES["hal_fwd"] += 1
    return y


def hal_dgrad(g, weight, need_s: bool = True,
              need_d: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Cotangents of (static (B,H,W,3), dynamic (B,F,H,W,1)) from planar ȳ
    (B, 3, F, H, W), in ȳ's dtype; a flag left False skips that output."""
    if g.dim() != 5 or g.shape[1] != 3:
        raise ValueError(f"ȳ must be planar (B, 3, F, H, W), got {tuple(g.shape)}")
    if tuple(weight.shape) != (3, 4, 3, 3, 3):
        raise ValueError(f"weight must be (3, 4, 3, 3, 3), got {tuple(weight.shape)}")
    if not (need_s or need_d):
        return None, None
    if _on_cpu(g, weight):
        return hal_dgrad_plain(g, weight, need_s, need_d)
    _check_cuda_inputs("hal_dgrad", g)
    b, _, frames, h, w = g.shape
    wb = _flat_weights(weight, torch.zeros(3, device=g.device))
    ds = torch.empty(b, h, w, 3, device=g.device, dtype=g.dtype) if need_s else None
    dd = (torch.empty(b, frames, h, w, 1, device=g.device, dtype=g.dtype)
          if need_d else None)
    rc = _lib().hal_dgrad(_DTYPE_CODE[g.dtype], g.data_ptr(), wb.data_ptr(),
                          ds.data_ptr() if need_s else None,
                          dd.data_ptr() if need_d else None,
                          b, frames, h, w, _stream())
    _check_rc(rc, "hal_dgrad")
    LAUNCHES["hal_dgrad"] += 1
    return ds, dd


def hal_wgrad(g, static, dynamic) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cotangents (dweight (3,4,3,3,3), dbias (3,)) from planar ȳ,
    reduced over all samples."""
    _check_shapes(static, dynamic)
    b, frames, h, w, _ = dynamic.shape
    if tuple(g.shape) != (b, 3, frames, h, w):
        raise ValueError(f"ȳ must be {(b, 3, frames, h, w)}, got {tuple(g.shape)}")
    if _on_cpu(g, static, dynamic):
        return hal_wgrad_plain(g, static, dynamic)
    _check_cuda_inputs("hal_wgrad", g, static, dynamic)
    nchunk = -(-(h * w) // _WGRAD_PIXELS_PER_BLOCK)
    part = torch.empty(nchunk * b, 327, device=g.device, dtype=torch.float32)
    out = torch.empty(327, device=g.device, dtype=torch.float32)
    rc = _lib().hal_wgrad(_DTYPE_CODE[g.dtype], g.data_ptr(), static.data_ptr(),
                          dynamic.data_ptr(), part.data_ptr(), nchunk,
                          out.data_ptr(), b, frames, h, w, _stream())
    _check_rc(rc, "hal_wgrad")
    LAUNCHES["hal_wgrad"] += 1
    dk = out[:324].view(3, 3, 3, 4, 3).permute(4, 3, 0, 1, 2)
    return dk, out[324:]


class HalConv(torch.autograd.Function):
    """y_planar = hal_fwd(...); backward = hal_dgrad (for the inputs that
    need it) + hal_wgrad."""

    @staticmethod
    def forward(ctx, static, dynamic, weight, bias):
        ctx.save_for_backward(static, dynamic, weight)
        return hal_fwd(static, dynamic, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        static, dynamic, weight = ctx.saved_tensors
        need_s, need_d, need_w, need_b = ctx.needs_input_grad
        g = g.contiguous()
        ds, dd = hal_dgrad(g, weight, need_s, need_d)
        dw = db = None
        if need_w or need_b:
            dk, dbias = hal_wgrad(g, static, dynamic)
            dw = dk.to(weight.dtype) if need_w else None
            db = dbias.to(weight.dtype) if need_b else None
        return ds, dd, dw, db


def hal_conv(static, dynamic, weight, bias):
    """y = Conv3d([broadcast(static) | dynamic], weight, pad 1) + bias as a
    (B, F, H, W, 3) view of channel-planar storage."""
    y = HalConv.apply(static.contiguous(), dynamic.contiguous(), weight, bias)
    return y.permute(0, 2, 3, 4, 1)
