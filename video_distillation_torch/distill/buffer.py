"""Expert-trajectory generation ("buffer") for MTT, and loading the buffers.

Port of ``video_distillation_tpu/distill/buffer.py`` (parity with the
reference's ``buffer.py``): train ``num_experts`` fresh teachers on the
real training split with SGD(lr_teacher, momentum=mom, weight_decay=l2)
(defaults 0.01/0/0, buffer.sh), snapshotting the full parameter vector at
init and after every epoch (buffer.py:73-89); optional LR x0.1 after epoch
``train_epochs//2 + 1`` with a momentum reset (buffer.py:91-94). Batches
follow the reference ``epoch()``: a numpy permutation per epoch padded with
-1, a gather from the uint8 clip store on the device, normalisation, a
per-access random hflip (dataset.py:400-403), scalar batch standardisation
(utils.py:770) and cross entropy on fp32 logits.

``compute_dtype='bfloat16'`` (the ``BufferConfig`` default) runs the net
in bf16 from fp32 master weights; the snapshots are fp32. A snapshot is
the JAX package's flat vector (``distill/params.py``), written as
``replay_buffer_{n}.npz`` by ``TrajectoryBuffer.save``, so either package
reads the other's buffers.

Data parallelism (``parallel/dist.py``): the batch is rounded up to a
multiple of the world size (JAX buffer.py:128, so an expert's batches
change with the device count when ``batch_train`` is not a multiple of
it); each rank takes its columns of every step's -1-padded batch, draws
the flips and dropout keep-masks of the whole batch, standardises with
statistics summed over the ranks and sums the gradient; only the
coordinator writes the buffers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..config import BufferConfig
from ..data.store import ClipStore, VideoData
from ..parallel import dist
from ..utils.device import resolve_device, step_generator
from .evaluate import _batch_standardize, _cdiv, fresh_net
from .mtt import (_DTYPES, TrajectoryBuffer, draw_keep_mask, masked_ce,
                  plan_denoms)


@dataclasses.dataclass
class ExpertDraws:
    """Injected randomness for ``train_expert``: the initial flat
    parameters θ (JAX order) and the hflip decisions, ``flips[epoch][step]``
    a (batch,) boolean array."""

    theta: Any
    flips: Sequence


def train_expert(generator: Optional[torch.Generator], store: ClipStore,
                 cfg: BufferConfig, np_rng: np.random.Generator, device,
                 draws: Optional[ExpertDraws] = None, keep_masks=None):
    """Train one teacher; returns its (E+1, P) float32 trajectory and its
    final-epoch train accuracy. ``keep_masks[epoch][step]``, if given, is
    that step's dropout keep-mask in the JAX layout."""
    meta = store.meta
    clips = store.device_clips(device, sharded=cfg.shard_store)
    model, theta, layout = fresh_net(cfg.model, meta, cfg.frames, generator,
                                     device, None if draws is None else draws.theta)
    cdt = _DTYPES[cfg.compute_dtype]
    # fp32 master weights (fp64 in an fp64 reference run)
    master = torch.promote_types(cdt, torch.float32)
    theta = theta.to(master)
    mom = torch.zeros_like(theta)
    labels = torch.as_tensor(store.labels, device=device).long()

    n = len(store)
    batch = min(cfg.batch_train, n)
    batch += (-batch) % dist.world_size()
    nb = _cdiv(n, batch)
    # each snapshot is a copy on the host, never a view of the live θ: on
    # the CPU, .detach().cpu() would alias it (ROADMAP C.1)
    snapshots = [theta.to("cpu", copy=True)]
    lr = cfg.lr_teacher
    decay_after = cfg.train_epochs // 2 + 1 if cfg.decay else None
    acc = 0.0
    for e in range(cfg.train_epochs):
        perm = np_rng.permutation(n)
        pad = nb * batch - n
        if pad:
            perm = np.concatenate([perm, np.full(pad, -1, perm.dtype)])
        plan = torch.as_tensor(perm.reshape(nb, batch), device=device).long()
        corrects, counts = [], []
        for s in range(nb):
            idx = dist.split_columns(plan[s], fill=-1)
            w = (idx >= 0).float()
            safe = idx.clamp_min(0)
            # fp32 (fp64 in an fp64 reference run) until the net's cast
            x = store.normalize(store.gather_clips(clips, safe)).to(master)
            if draws is not None:
                flip = torch.as_tensor(np.asarray(draws.flips[e][s]),
                                       device=device).bool()
            else:
                flip = torch.rand(batch, generator=generator,
                                  device=device) < 0.5
            km = (draw_keep_mask(model, generator, batch, *x.shape[1:4],
                                 device) if keep_masks is None
                  else torch.as_tensor(keep_masks[e][s], device=device))
            flip = dist.split_columns(flip)
            x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
            x = _batch_standardize(x, w, across_ranks=True)
            theta.requires_grad_(True)
            params = {k: v.to(cdt) for k, v in layout.unflatten(theta).items()}
            logits = functional_call(
                model, params, (x.to(cdt),),
                dict(train=True, generator=generator,
                     keep_mask=None if km is None else dist.split_columns(
                         km, 0, fill=True)))
            y = labels[safe]
            loss = masked_ce(logits, y, w, plan_denoms(plan[s]))
            (grad,) = torch.autograd.grad(loss, theta)
            dist.all_reduce_(grad)
            with torch.no_grad():
                theta = theta.detach()
                mom = cfg.mom * mom + grad + cfg.l2 * theta
                theta = theta - lr * mom
                corrects.append(((logits.float().argmax(-1) == y).float()
                                 * w).sum())
                counts.append((plan[s] >= 0).sum())
        snapshots.append(theta.to("cpu", copy=True))
        correct = dist.all_reduce_(torch.stack(corrects).sum())
        acc = float(correct / torch.stack(counts).sum())
        if e == decay_after:
            lr *= 0.1
            mom = torch.zeros_like(theta)  # optimizer recreated
    return torch.stack(snapshots).numpy(), acc


def generate_buffers(data: VideoData, cfg: BufferConfig,
                     progress=None) -> list:
    """Train all experts; writes replay_buffer_{n}.npz files every
    ``save_interval`` experts (buffer.py:98-104). Returns the file paths.
    Expert ``i`` draws from ``step_generator(cfg.seed, i)``; the batch
    permutations from one numpy generator seeded ``cfg.seed``. Every rank
    trains each expert; the coordinator writes the files."""
    device = resolve_device(cfg.device)
    os.makedirs(cfg.buffer_path, exist_ok=True)
    np_rng = np.random.default_rng(cfg.seed)
    paths = []
    trajectories = []
    # the first free file number, found before any rank writes
    n = 0
    while os.path.exists(os.path.join(cfg.buffer_path,
                                      f"replay_buffer_{n}.npz")):
        n += 1
    for it in range(cfg.num_experts):
        traj, acc = train_expert(step_generator(cfg.seed, it, device),
                                 data.train, cfg, np_rng, device)
        trajectories.append(traj)
        if progress:
            progress(it, acc)
        if len(trajectories) == cfg.save_interval:
            path = os.path.join(cfg.buffer_path, f"replay_buffer_{n}.npz")
            if dist.is_coordinator():
                TrajectoryBuffer(np.stack(trajectories)).save(path)
            paths.append(path)
            trajectories = []
            n += 1
    return paths


def load_buffers(buffer_path: str) -> list:
    """Load all replay_buffer_{n}.npz files (distill_baseline.py:122-128)."""
    if not buffer_path:
        raise ValueError(
            "MTT requires expert trajectories: pass --buffer_path pointing "
            "at a directory of replay_buffer_{n}.npz files (generate them "
            "with python -m video_distillation_torch.drivers.buffer)")
    buffers = []
    n = 0
    while os.path.exists(os.path.join(buffer_path,
                                      f"replay_buffer_{n}.npz")):
        buffers.append(TrajectoryBuffer.load(
            os.path.join(buffer_path, f"replay_buffer_{n}.npz")))
        n += 1
    if not buffers:
        raise FileNotFoundError(f"No buffers detected at {buffer_path}")
    return buffers
