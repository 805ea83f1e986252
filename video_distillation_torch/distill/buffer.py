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
from ..utils.device import resolve_device, step_generator
from .evaluate import _batch_standardize, _cdiv, fresh_net
from .mtt import _DTYPES, TrajectoryBuffer, masked_ce


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
    mom = torch.zeros_like(theta)
    cdt = _DTYPES[cfg.compute_dtype]
    labels = torch.as_tensor(store.labels, device=device).long()

    n = len(store)
    batch = min(cfg.batch_train, n)
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
            idx = plan[s]
            w = (idx >= 0).float()
            safe = idx.clamp_min(0)
            x = store.normalize(store.gather_clips(clips, safe))
            if draws is not None:
                flip = torch.as_tensor(np.asarray(draws.flips[e][s]),
                                       device=device).bool()
            else:
                flip = torch.rand(batch, generator=generator,
                                  device=device) < 0.5
            x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
            x = _batch_standardize(x, w)
            theta.requires_grad_(True)
            params = {k: v.to(cdt) for k, v in layout.unflatten(theta).items()}
            logits = functional_call(
                model, params, (x.to(cdt),),
                dict(train=True, generator=generator,
                     keep_mask=None if keep_masks is None else keep_masks[e][s]))
            y = labels[safe]
            loss = masked_ce(logits, y, w)
            (grad,) = torch.autograd.grad(loss, theta)
            with torch.no_grad():
                theta = theta.detach()
                mom = cfg.mom * mom + grad + cfg.l2 * theta
                theta = theta - lr * mom
                corrects.append(((logits.float().argmax(-1) == y).float()
                                 * w).sum())
                counts.append(w.sum())
        snapshots.append(theta.to("cpu", copy=True))
        acc = float(torch.stack(corrects).sum() / torch.stack(counts).sum())
        if e == decay_after:
            lr *= 0.1
            mom = torch.zeros_like(theta)  # optimizer recreated
    return torch.stack(snapshots).numpy(), acc


def generate_buffers(data: VideoData, cfg: BufferConfig,
                     progress=None) -> list:
    """Train all experts; writes replay_buffer_{n}.npz files every
    ``save_interval`` experts (buffer.py:98-104). Returns the file paths.
    Expert ``i`` draws from ``step_generator(cfg.seed, i)``; the batch
    permutations from one numpy generator seeded ``cfg.seed``."""
    device = resolve_device(cfg.device)
    os.makedirs(cfg.buffer_path, exist_ok=True)
    np_rng = np.random.default_rng(cfg.seed)
    paths = []
    trajectories = []
    for it in range(cfg.num_experts):
        traj, acc = train_expert(step_generator(cfg.seed, it, device),
                                 data.train, cfg, np_rng, device)
        trajectories.append(traj)
        if progress:
            progress(it, acc)
        if len(trajectories) == cfg.save_interval:
            n = 0
            while os.path.exists(os.path.join(
                    cfg.buffer_path, f"replay_buffer_{n}.npz")):
                n += 1
            path = os.path.join(cfg.buffer_path, f"replay_buffer_{n}.npz")
            TrajectoryBuffer(np.stack(trajectories)).save(path)
            paths.append(path)
            trajectories = []
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
