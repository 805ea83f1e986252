"""The phase-max trio: Hopper kernels, plain versions, autograd.

Port of ``video_distillation_tpu/ops/pallas/phase_trio.py``. ConvNet3D's
fused first stage ends in a max over the four 2x2-pool phases, which the
stride-2 GEMM leaves as four contiguous O-wide channel blocks of each
(N, 4O) row. Three hand-written CUDA kernels (``csrc/phase_trio.cu``):

* ``phase_argmax(y, G)``: the max m and the winning phase idx (uint8, 0..3);
  ties go to the first maximum (torch's MaxPool2d order), through the
  where-chain of ``layers.py:683-715``, never ``amax``, whose gradient
  splits ties;
* ``phase_select(t, idx, G)``: the winner's tangent, t[n, idx*O + o];
* ``phase_scatter(c, idx, G)``: c into the winner's slot, zeros elsewhere, the
  exact transpose of select.

Layouts: y and scatter's output are row-major (N, 4O); idx is (N, O). m,
select's output and scatter's input c are channel-planar with
``rows_per_batch`` G rows a batch, (N/G, O, G). ConvNet3D passes
G = F*Ho*Wo, so m is the NCDHW tensor its second stage reads.

Each wrapper runs its kernel for CUDA tensors (float32 or bfloat16,
contiguous; anything else raises) and, for CPU tensors and only for those,
its plain version. ``LAUNCHES`` counts kernel launches per wrapper.

The autograd closure mirrors ``phase_trio.py:169-194``:
``PhaseArgmax.backward`` is ``PhaseScatter``, and ``PhaseScatter`` and
``PhaseSelect`` are each other's backward, all with the forward's idx as a
constant. That keeps them differentiable to any order inside the MTT
unroll's ``create_graph`` pass; none may be ``once_differentiable``.
Each has a ``torch.func.vmap`` rule (below) that folds the nets into the
rows and launches its kernel once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .hal_conv import (_DTYPE_CODE, _check_cuda_inputs, _check_rc, _on_cpu,
                       _stream)

LAUNCHES = {"phase_argmax": 0, "phase_select": 0, "phase_scatter": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("phase_trio")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.phase_argmax, lib.phase_select, lib.phase_scatter):
            fn.restype = ctypes.c_int
        lib.phase_argmax.argtypes = [i, p, p, p, i, i, i, p]
        lib.phase_select.argtypes = [i, p, p, p, i, i, i, p]
        lib.phase_scatter.argtypes = [i, p, p, p, i, i, i, p]
        _LIB = lib
    return _LIB


def _check_rows(n: int, g: int):
    if g <= 0 or n % g:
        raise ValueError(f"rows_per_batch {g} must be positive and divide N={n}")


def _check_idx(idx, n, o):
    if idx.dtype != torch.uint8 or tuple(idx.shape) != (n, o):
        raise ValueError(f"idx must be uint8 ({n}, {o}), got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def _check_cuda(name, n, t, idx=None):
    _check_cuda_inputs(name, t)
    if idx is not None and not idx.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows exceed the kernel's int rows")


def to_planar(m, g: int):
    """Row-major (N, O) -> channel-planar (N/g, O, g)."""
    n, o = m.shape
    return m.reshape(n // g, g, o).transpose(1, 2).contiguous()


def from_planar(c):
    """Channel-planar (N/G, O, G) -> row-major (N, O)."""
    b, o, g = c.shape
    return c.transpose(1, 2).reshape(b * g, o)


def _planar_rows(c, g: int):
    """N and O of a planar O-wide tensor with g rows a batch."""
    if c.dim() != 3 or c.shape[2] != g:
        raise ValueError(f"expected (N/{g}, O, {g}), got {tuple(c.shape)}")
    return c.shape[0] * g, c.shape[1]


def _wide_rows(y):
    if y.dim() != 2 or y.shape[1] % 4:
        raise ValueError(f"expected (N, 4*O), got {tuple(y.shape)}")
    return y.shape[0], y.shape[1] // 4


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def phase_argmax_plain(y, rows_per_batch: int):
    """(m, idx): the where-chain of ``layers._phase_max_jvp`` with ``>=``
    masks, so a tie goes to the first maximum."""
    y0, y1, y2, y3 = y.chunk(4, dim=1)
    a01, a23 = y0 >= y1, y2 >= y3
    m01, m23 = torch.where(a01, y0, y1), torch.where(a23, y2, y3)
    top = m01 >= m23
    i01 = torch.where(a01, 0, 1).to(torch.uint8)
    i23 = torch.where(a23, 2, 3).to(torch.uint8)
    return (to_planar(torch.where(top, m01, m23), rows_per_batch),
            torch.where(top, i01, i23))


def phase_select_plain(t, idx, rows_per_batch: int):
    """t[n, idx*O + o] by a where-chain over the four phase blocks."""
    t0, t1, t2, t3 = t.chunk(4, dim=1)
    out = torch.where(idx == 0, t0, torch.where(
        idx == 1, t1, torch.where(idx == 2, t2, t3)))
    return to_planar(out, rows_per_batch)


def phase_scatter_plain(c, idx, rows_per_batch: int):
    """c into phase block idx of each row, zeros in the other three."""
    c = from_planar(c)
    zero = torch.zeros_like(c)
    return torch.cat([torch.where(idx == k, c, zero) for k in range(4)], dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def phase_argmax(y, rows_per_batch: int):
    """(N, 4O) -> (m planar (N/G, O, G), idx (N, O) uint8)."""
    n, o = _wide_rows(y)
    _check_rows(n, rows_per_batch)
    if _on_cpu(y):
        return phase_argmax_plain(y, rows_per_batch)
    _check_cuda("phase_argmax", n, y)
    m = torch.empty(n // rows_per_batch, o, rows_per_batch, device=y.device,
                    dtype=y.dtype)
    idx = torch.empty(n, o, device=y.device, dtype=torch.uint8)
    rc = _lib().phase_argmax(_DTYPE_CODE[y.dtype], y.data_ptr(), m.data_ptr(),
                             idx.data_ptr(), n, o, rows_per_batch, _stream())
    _check_rc(rc, "phase_argmax")
    LAUNCHES["phase_argmax"] += 1
    return m, idx


def phase_select(t, idx, rows_per_batch: int):
    """(N, 4O) tangent -> the winner's, planar (N/G, O, G)."""
    n, o = _wide_rows(t)
    _check_rows(n, rows_per_batch)
    _check_idx(idx, n, o)
    if _on_cpu(t, idx):
        return phase_select_plain(t, idx, rows_per_batch)
    _check_cuda("phase_select", n, t, idx)
    out = torch.empty(n // rows_per_batch, o, rows_per_batch, device=t.device,
                      dtype=t.dtype)
    rc = _lib().phase_select(_DTYPE_CODE[t.dtype], t.data_ptr(), idx.data_ptr(),
                             out.data_ptr(), n, o, rows_per_batch, _stream())
    _check_rc(rc, "phase_select")
    LAUNCHES["phase_select"] += 1
    return out


def phase_scatter(c, idx, rows_per_batch: int):
    """Planar (N/G, O, G) cotangent -> (N, 4O), c in the winner's slot."""
    n, o = _planar_rows(c, rows_per_batch)
    _check_idx(idx, n, o)
    if _on_cpu(c, idx):
        return phase_scatter_plain(c, idx, rows_per_batch)
    _check_cuda("phase_scatter", n, c, idx)
    out = torch.empty(n, 4 * o, device=c.device, dtype=c.dtype)
    rc = _lib().phase_scatter(_DTYPE_CODE[c.dtype], c.data_ptr(), idx.data_ptr(),
                              out.data_ptr(), n, o, rows_per_batch, _stream())
    _check_rc(rc, "phase_scatter")
    LAUNCHES["phase_scatter"] += 1
    return out


# The vmap rules mirror ``_fold_rows`` / ``_bin_batcher`` (phase_trio.py:
# 205-225): the mapped axis goes to the front and folds into the rows, as
# (V*N, 4O), and ONE call of the unbatched Function runs on them. The nets
# are the outermost part of the rows, so with N % G == 0 no G-row group
# straddles two nets and a planar (V*N/G, O, G) result reshapes to
# (V, N/G, O, G). Select and scatter need both operands mapped, as in JAX.

def _fold(t, d):
    """(V*N, ...) contiguous rows of a mapped operand, and N."""
    t = t.movedim(d, 0)
    return t.flatten(0, 1).contiguous(), t.shape[1]


def _check_groups(n: int, rows_per_batch: int):
    if rows_per_batch <= 0 or n % rows_per_batch:
        raise ValueError(f"vmap: rows_per_batch {rows_per_batch} must divide "
                         f"each net's N={n}, so no group straddles two nets")


def _both_mapped(name, in_dims):
    if in_dims[0] is None or in_dims[1] is None:
        raise NotImplementedError(f"{name}: both operands must share the "
                                  "vmapped axis")


class PhaseArgmax(torch.autograd.Function):
    """(m, idx) = phase_argmax(y); m's backward is PhaseScatter, idx has
    none."""

    @staticmethod
    def forward(y, rows_per_batch):
        return phase_argmax(y, rows_per_batch)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])
        ctx.rows_per_batch = inputs[1]

    @staticmethod
    def backward(ctx, g, _):
        (idx,) = ctx.saved_tensors
        return PhaseScatter.apply(g.contiguous(), idx, ctx.rows_per_batch), None

    @staticmethod
    def vmap(info, in_dims, y, rows_per_batch):
        y, n = _fold(y, in_dims[0])
        _check_groups(n, rows_per_batch)
        m, idx = PhaseArgmax.apply(y, rows_per_batch)
        v = info.batch_size
        return (m.unflatten(0, (v, -1)), idx.unflatten(0, (v, n))), (0, 0)


class PhaseSelect(torch.autograd.Function):
    """Linear in t for a constant idx; its backward is PhaseScatter."""

    @staticmethod
    def forward(t, idx, rows_per_batch):
        return phase_select(t, idx, rows_per_batch)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.rows_per_batch = inputs[2]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return (PhaseScatter.apply(g.contiguous(), idx, ctx.rows_per_batch),
                None, None)

    @staticmethod
    def vmap(info, in_dims, t, idx, rows_per_batch):
        _both_mapped("phase_select", in_dims)
        t, n = _fold(t, in_dims[0])
        idx, _ = _fold(idx, in_dims[1])
        _check_groups(n, rows_per_batch)
        out = PhaseSelect.apply(t, idx, rows_per_batch)
        return out.unflatten(0, (info.batch_size, -1)), 0


class PhaseScatter(torch.autograd.Function):
    """Linear in c for a constant idx; its backward is PhaseSelect."""

    @staticmethod
    def forward(c, idx, rows_per_batch):
        return phase_scatter(c, idx, rows_per_batch)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.rows_per_batch = inputs[2]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return (PhaseSelect.apply(g.contiguous(), idx, ctx.rows_per_batch),
                None, None)

    @staticmethod
    def vmap(info, in_dims, c, idx, rows_per_batch):
        _both_mapped("phase_scatter", in_dims)
        c, _ = _fold(c, in_dims[0])  # planar (V*N/G, O, G)
        idx, n = _fold(idx, in_dims[1])
        _check_groups(n, rows_per_batch)
        out = PhaseScatter.apply(c, idx, rows_per_batch)
        return out.unflatten(0, (info.batch_size, n)), 0


def phase_max(y, rows_per_batch: int):
    """Differentiable max over the four phase blocks of (N, 4O) rows,
    channel-planar (N/G, O, G) with G = ``rows_per_batch``."""
    return PhaseArgmax.apply(y.contiguous(), rows_per_batch)[0]
