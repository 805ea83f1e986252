"""Data parallelism over ``torch.distributed``: ranks, plans, all-reduces.

The counterpart of ``video_distillation_tpu/parallel/mesh.py``. The JAX
package runs every path as one sharded ``jit`` over a device mesh: batch
plans are padded with -1 to a multiple of the device count and sharded
over their batch axis, parameters and synthetic sets are replicated, and
XLA inserts the all-reduces. Here each rank is one process on one card
(``torchrun --nproc_per_node=N``); every rank holds the replicated state
and the whole host-drawn plan, computes its own columns of the batch, and
the steps sum what the columns contribute with the all-reduces below.

Rules the steps follow, so that world size n computes what world size 1
computes:

* every random draw (slot bits, dropout keep-masks, flips) is made over the
  global, unpadded batch on every rank from the same generator, in the order
  a world-size-1 run makes it, and only then padded and split
  (``split_columns``);
* a mean over the batch divides by the global weight sum, known from the
  whole plan;
* a gradient that only replicated computation produced (DM's synthetic
  side, an unsplit pool step) is broadcast from rank 0
  (``broadcast_tensors_``): the card's atomics-based backward kernels
  (pooling, scatter-add) need not give two ranks the same bits, and the
  replicas must stay equal;
* a gradient that flows through an all-reduce inside the differentiated
  function (an MTT inner step's) goes through ``reduced``, whose backward
  is again a SUM all-reduce; each rank then backpropagates its loss divided
  by n (``share``) and SUM-all-reduces the gradients of the replicated
  leaves (``all_reduce_tensors_``). With the full loss on every rank, the
  replicated loss's cotangent would enter each rank's local gradient n
  times over through that backward all-reduce.

Without a process group every helper is the identity: world size 1, rank
0, no collective. ``STATS`` counts the collectives and their bytes.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

# collectives issued since the last reset_stats(), and their payload bytes
STATS = {"all_reduce": 0, "broadcast": 0, "bytes": 0}
# True when init_distributed built the group from the launcher's
# environment; False for a group the caller built
_OWN_GROUP = False


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def active() -> bool:
    """Whether a process group is initialised."""
    return tdist.is_available() and tdist.is_initialized()


def owns_group() -> bool:
    return active() and _OWN_GROUP


def world_size() -> int:
    return tdist.get_world_size() if active() else 1


def rank() -> int:
    return tdist.get_rank() if active() else 0


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` under ``torchrun``,
    else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_coordinator() -> bool:
    """The rank that writes logs, checkpoints and artifacts."""
    return rank() == 0


def init_distributed(device="cuda") -> bool:
    """Join the launch's process group.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` set) this builds the group: NCCL for a
    CUDA ``device``, gloo for the CPU; each rank takes card ``LOCAL_RANK``.
    A group the caller has already initialised is used as it is. Without
    that environment it returns False and the run is world size 1 with no
    group, on the device asked for (the JAX ``init_distributed``'s silent
    no-op). Returns whether a group is in use."""
    global _OWN_GROUP
    if active():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    n, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        lr = int(os.environ.get("LOCAL_RANK", r))
        if lr >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {lr} but {torch.cuda.device_count()} CUDA "
                "device(s): launch at most one rank a card")
        torch.cuda.set_device(lr)
        backend = "nccl"
    else:
        backend = "gloo"
    tdist.init_process_group(backend, init_method="env://", world_size=n,
                             rank=r)
    _OWN_GROUP = True
    return True


def check_mesh_shape(mesh_shape: Optional[Sequence[int]]):
    """A config's ``mesh_shape`` must hold the launch's ranks: its product
    equals the world size. ``(1,)``, the default, stands for any launch."""
    if mesh_shape is None:
        return
    size = math.prod(mesh_shape)
    if size != 1 and size != world_size():
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} holds {size} "
                         f"devices, the launch {world_size()} ranks")


def _pad_last(x, pad: int, fill, axis: int = -1):
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_full(shape, fill)], dim=axis)
    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=axis)


def split_columns(x, axis: int = -1, fill=0):
    """This rank's share of ``x`` along ``axis``, after padding that axis
    with ``fill`` to a multiple of the world size: rank r takes the r-th
    of n equal slices. ``x`` itself without a group."""
    n = world_size()
    if n == 1:
        return x
    axis = axis % x.ndim
    x = _pad_last(x, (-x.shape[axis]) % n, fill, axis)
    per = x.shape[axis] // n
    index = [slice(None)] * x.ndim
    index[axis] = slice(rank() * per, (rank() + 1) * per)
    return x[tuple(index)]


def pad_and_split_plan(plan):
    """(padded plan, this rank's columns): a (..., batch) index plan padded
    with -1 along its last axis to a multiple of the world size (the JAX
    ``pad_and_shard_plan``), and the r-th of n equal column slices of it.
    The -1 columns weigh 0 in every loss."""
    n = world_size()
    padded = _pad_last(plan, (-plan.shape[-1]) % n, -1)
    return padded, split_columns(padded, fill=-1)


def split_divisible(x):
    """(axis, this rank's share): ``x`` split over its first axis whose size
    the world size divides (the JAX ``shard_divisible``), or (None, x),
    replicated, where none does."""
    n = world_size()
    for axis, dim in enumerate(x.shape):
        if dim % n == 0:
            return axis, split_columns(x, axis)
    return None, x


def _count(t: torch.Tensor, kind: str = "all_reduce"):
    STATS[kind] += 1
    STATS["bytes"] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, op=None) -> torch.Tensor:
    """SUM (or ``op``) all-reduce of a contiguous tensor, in place; the
    tensor unchanged without a group."""
    if active():
        _count(t)
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM if op is None else op)
    return t


def _flat_(tensors: Sequence[torch.Tensor], collective):
    """``collective`` on one flat buffer per dtype of ``tensors``, copied
    back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        o = 0
        for t in group:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def all_reduce_tensors_(tensors: Sequence[torch.Tensor]):
    """SUM-all-reduce each tensor in place, through one flat buffer per
    dtype (one collective for a step's gradients)."""
    if active():
        _flat_(tensors, all_reduce_)


def _broadcast_(t: torch.Tensor):
    _count(t, "broadcast")
    tdist.broadcast(t, src=0)


def broadcast_tensors_(tensors: Sequence[torch.Tensor]):
    """Rank 0's values of each tensor on every rank, in place, through one
    flat buffer per dtype; unchanged without a group."""
    if active():
        _flat_(tensors, _broadcast_)


def reduce_scatter(stacked: torch.Tensor) -> torch.Tensor:
    """``stacked[rank]`` summed over the ranks, for a (world size, ...)
    tensor: NCCL's reduce-scatter; gloo, which reduces CUDA tensors but
    does not scatter them, all-reduces the whole and takes the slice."""
    if not active():
        return stacked[0]
    if str(tdist.get_backend()) != "nccl":
        return all_reduce_(stacked)[rank()]
    out = torch.empty_like(stacked[0])
    _count(stacked)
    tdist.reduce_scatter_tensor(out, stacked.contiguous())
    return out


class _Reduced(torch.autograd.Function):
    """SUM all-reduce whose backward SUM-all-reduces the cotangents (each
    rank's cotangent of a replicated value is its share of the true one;
    see the module docstring). The backward applies the Function again, so
    it is differentiable to any order."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _Reduced.apply(g)


def reduced(t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks; ``t`` without a
    group."""
    return _Reduced.apply(t) if active() else t


def share(loss: torch.Tensor) -> torch.Tensor:
    """A replicated loss divided by the world size: what each rank
    backpropagates, so that the SUM all-reduce of the replicated leaves'
    gradients is the gradient of the loss."""
    n = world_size()
    return loss / n if n > 1 else loss
