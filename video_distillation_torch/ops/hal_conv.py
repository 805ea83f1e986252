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

``HalConv`` wires the three together as a ``torch.autograd.Function``
(its backward through ``HalDgrad`` and ``HalWgrad``). It has no double
backward: the hallucinator sits outside the MTT inner unroll, so its
outputs are only ever differentiated once. Each Function has a
``torch.func.vmap`` rule, the counterpart of the JAX primitive's batching
rule: the nets fold into the sample axis and each kernel launches once;
a mapped weight or bias raises, as the JAX rule does.
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
_WGRAD_BAND_ROWS = 8  # kBR in csrc/hal_conv.cu: pixel rows a wgrad block
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
        raise ValueError(f"kernel inputs must share one CUDA device or "
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

def _acc(t):
    """The plain versions' working dtype: fp32, as the kernels accumulate,
    or fp64 for fp64 inputs (a reference run on the CPU)."""
    return torch.promote_types(t.dtype, torch.float32)


def hal_fwd_plain(static, dynamic, weight, bias):
    """Planar y (B, 3, F, H, W): naive broadcast + concat + conv3d in fp32
    (fp64 for fp64 inputs), cast to the dynamic input's dtype."""
    b, frames, h, w, _ = dynamic.shape
    acc = _acc(dynamic)
    s = static.to(acc).permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, frames, h, w)
    x = torch.cat([s, dynamic.to(acc).permute(0, 4, 1, 2, 3)], dim=1)
    y = F.conv3d(x, weight.to(acc), bias.to(acc), padding=1)
    return y.to(dynamic.dtype)


def hal_dgrad_plain(g, weight, need_s: bool = True, need_d: bool = True):
    """(ds (B,H,W,3) | None, dd (B,F,H,W,1) | None) in ȳ's dtype, by autograd
    of the plain forward (linear in static and dynamic)."""
    b, _, frames, h, w = g.shape
    acc = _acc(g)
    with torch.enable_grad():
        s = torch.zeros(b, h, w, 3, device=g.device, dtype=acc,
                        requires_grad=True)
        d = torch.zeros(b, frames, h, w, 1, device=g.device, dtype=acc,
                        requires_grad=True)
        y = hal_fwd_plain(s, d, weight.detach().to(acc),
                          torch.zeros(3, device=g.device, dtype=acc))
        ds, dd = torch.autograd.grad(y, (s, d), g.to(acc))
    return (ds.to(g.dtype) if need_s else None,
            dd.to(g.dtype) if need_d else None)


def hal_wgrad_plain(g, static, dynamic):
    """(dweight (3,4,3,3,3), dbias (3,)) in fp32 (fp64 for fp64 inputs),
    by autograd of the plain forward (linear in weight and bias)."""
    acc = _acc(g)
    with torch.enable_grad():
        wt = torch.zeros(3, 4, 3, 3, 3, device=g.device, dtype=acc,
                         requires_grad=True)
        bs = torch.zeros(3, device=g.device, dtype=acc, requires_grad=True)
        y = hal_fwd_plain(static.to(acc), dynamic.to(acc), wt, bs)
        dw, db = torch.autograd.grad(y, (wt, bs), g.to(acc))
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


def hal_wgrad(g, static, dynamic, nets: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cotangents (dweight (3,4,3,3,3), dbias (3,)) from planar ȳ,
    reduced over all samples; with ``nets`` > 1 the samples are that many
    nets' batches folded net-major, and each net's sums come back apart,
    (nets, 3,4,3,3,3) and (nets, 3), from the same single launch (the
    kernel's per-(band, sample) partials summed per net)."""
    _check_shapes(static, dynamic)
    b, frames, h, w, _ = dynamic.shape
    if tuple(g.shape) != (b, 3, frames, h, w):
        raise ValueError(f"ȳ must be {(b, 3, frames, h, w)}, got {tuple(g.shape)}")
    if nets < 1 or b % nets:
        raise ValueError(f"hal_wgrad: {nets} nets do not divide the batch {b}")
    if _on_cpu(g, static, dynamic):
        if nets == 1:
            return hal_wgrad_plain(g, static, dynamic)
        per = [hal_wgrad_plain(*(t.unflatten(0, (nets, -1))[v]
                                 for t in (g, static, dynamic)))
               for v in range(nets)]
        return (torch.stack([dk for dk, _ in per]),
                torch.stack([db for _, db in per]))
    _check_cuda_inputs("hal_wgrad", g, static, dynamic)
    nchunk = -(-h // _WGRAD_BAND_ROWS)
    part = torch.empty(nchunk * b, 327, device=g.device, dtype=torch.float32)
    out = torch.empty(327, device=g.device, dtype=torch.float32)
    rc = _lib().hal_wgrad(_DTYPE_CODE[g.dtype], g.data_ptr(), static.data_ptr(),
                          dynamic.data_ptr(), part.data_ptr(), nchunk,
                          out.data_ptr(), b, frames, h, w, _stream())
    _check_rc(rc, "hal_wgrad")
    LAUNCHES["hal_wgrad"] += 1
    if nets > 1:  # part is (band, sample, 327)
        out = part.view(nchunk, nets, b // nets, 327).sum((0, 2))
    dk = out[..., :324].unflatten(-1, (3, 3, 3, 4, 3))
    return dk.permute(*range(dk.dim() - 5), -1, -2, -5, -4, -3), out[..., 324:]


# ---------------------------------------------------------------------------
# autograd and vmap
#
# Each Function has the forward / setup_context form and a ``vmap`` rule,
# the counterpart of the JAX primitive's batching rule (hal_vjp.py:396-426):
# the rule moves the mapped axis to the front, broadcasts an unmapped
# operand to the mapped size, folds the nets into the sample axis and makes
# ONE call of the unbatched Function, so a batched call launches each
# kernel once. A backward calls Functions only (never the wrappers), so it
# runs batched too when ``torch.func.vmap`` wraps ``torch.func.grad``.
# ---------------------------------------------------------------------------

def _nets_first(info, in_dims, *tensors):
    """Each tensor with the mapped axis in front (an unmapped one broadcast
    to the batch size), contiguous."""
    return [(t.movedim(d, 0) if d is not None
             else t.unsqueeze(0).expand(info.batch_size, *t.shape)).contiguous()
            for t, d in zip(tensors, in_dims)]


class HalConv(torch.autograd.Function):
    """y_planar = hal_fwd(...); backward = HalDgrad (for the inputs that
    need it) + HalWgrad."""

    @staticmethod
    def forward(static, dynamic, weight, bias):
        return hal_fwd(static, dynamic, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        static, dynamic, weight, _ = inputs
        ctx.save_for_backward(static, dynamic, weight)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        static, dynamic, weight = ctx.saved_tensors
        need_s, need_d, need_w, need_b = ctx.needs_input_grad
        g = g.contiguous()
        ds = dd = dw = db = None
        if need_s or need_d:
            ds, dd = HalDgrad.apply(g, weight, need_s, need_d)
        if need_w or need_b:
            dk, dbias = HalWgrad.apply(g, static, dynamic)
            dw = dk.to(weight.dtype) if need_w else None
            db = dbias.to(weight.dtype) if need_b else None
        return ds, dd, dw, db

    @staticmethod
    def vmap(info, in_dims, static, dynamic, weight, bias):
        if in_dims[2] is not None or in_dims[3] is not None:
            raise NotImplementedError(
                "hal_conv: vmap over the weight or bias is not supported; "
                "per-net hallucinator parameters take the plain module "
                "(hal_fwd_plain)")
        s, d = _nets_first(info, in_dims, static, dynamic)
        v, b = d.shape[:2]
        y = HalConv.apply(s.flatten(0, 1), d.flatten(0, 1), weight, bias)
        return y.unflatten(0, (v, b)), 0


class HalDgrad(torch.autograd.Function):
    """(ds, dd) = hal_dgrad(ȳ, weight); a flag left False gives None. Used
    inside HalConv's backward only (no backward of its own)."""

    @staticmethod
    def forward(g, weight, need_s, need_d):
        return hal_dgrad(g, weight, need_s, need_d)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, weight, need_s, need_d):
        if in_dims[1] is not None:
            raise NotImplementedError(
                "hal_dgrad: vmap over the weight is not supported")
        (g,) = _nets_first(info, in_dims[:1], g)
        v, b = g.shape[:2]
        out = HalDgrad.apply(g.flatten(0, 1), weight, need_s, need_d)
        return (tuple(None if t is None else t.unflatten(0, (v, b))
                      for t in out),
                tuple(None if t is None else 0 for t in out))


class HalWgrad(torch.autograd.Function):
    """(dweight, dbias) = hal_wgrad(ȳ, static, dynamic), summed over the
    samples. Batched, each net's sums stay apart (one launch). Used inside
    HalConv's backward only (no backward of its own)."""

    @staticmethod
    def forward(g, static, dynamic, nets=1):
        return hal_wgrad(g, static, dynamic, nets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, static, dynamic, nets=1):
        if nets != 1:
            raise NotImplementedError("hal_wgrad: nested vmap")
        g, s, d = _nets_first(info, in_dims[:3], g, static, dynamic)
        return HalWgrad.apply(g.flatten(0, 1), s.flatten(0, 1),
                              d.flatten(0, 1), info.batch_size), (0, 0)


def hal_conv(static, dynamic, weight, bias):
    """y = Conv3d([broadcast(static) | dynamic], weight, pad 1) + bias as a
    (B, F, H, W, 3) view of channel-planar storage."""
    y = HalConv.apply(static.contiguous(), dynamic.contiguous(), weight, bias)
    return y.permute(0, 2, 3, 4, 1)
