"""Coreset baselines: k-center and herding selection in embedding space.

Port of ``video_distillation_tpu/distill/coreset.py`` (the reference's
``distill_coreset.py:24-110``): a frozen random net's features
(``output='feat'``) of every clip of a class; k-center seeds with the clip
closest to the class mean, then greedily adds the clip farthest from its
nearest centre (:75-91); herding greedily matches the running mean
(:92-110). The chosen clips, normalised, form the synthetic set.

The embed is DM's real-clip embed (``dm.real_features``: fp32
standardisation, train mode, ``output='feat'``) over chunks of ``chunk``
clips gathered from the device clip store (coreset.py:27-38, :89-97); the
greedy loops are the JAX package's numpy, copied as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.store import ClipStore
from ..models.registry import path_model
from .dm import norm_stats, real_chunk, real_features


def _kcenter(features: np.ndarray, ipc: int) -> list:
    mean = features.mean(axis=0, keepdims=True)
    dis = np.linalg.norm(features - mean, axis=1)
    idx_centers = [int(np.argsort(dis)[0])]
    for _ in range(ipc - 1):
        centers = features[idx_centers]  # (k, D)
        d = np.linalg.norm(features[:, None] - centers[None], axis=-1)
        dis_min = d.min(axis=1)
        idx_centers.append(int(np.argmax(dis_min)))
    return idx_centers


def _herding(features: np.ndarray, ipc: int) -> list:
    mean = features.mean(axis=0, keepdims=True)
    idx_selected: list = []
    idx_left = list(range(features.shape[0]))
    for i in range(ipc):
        if idx_selected:
            det = mean * (i + 1) - features[idx_selected].sum(axis=0)
        else:
            det = mean * (i + 1)
        dis = np.linalg.norm(det - features[idx_left], axis=1)
        j = int(np.argmin(dis))
        idx_selected.append(idx_left[j])
        del idx_left[j]
    return idx_selected


SELECTORS = {"k-center": _kcenter, "herding": _herding}


def select_coreset(generator: Optional[torch.Generator], store: ClipStore,
                   model_name: str, ipc: int, method: str = "k-center",
                   frames: int = 16, params=None, chunk: int = 64,
                   device="cuda"):
    """(syn_images (C*ipc, *item) normalised fp32, labels), on ``device``,
    in the store's own item shape: (F, H, W, C) clips or (H, W, C) images.
    The net is drawn from ``generator`` unless ``params`` (the torch
    parameter names, e.g. a JAX net through ``from_jax_params``) are given.
    A class with fewer than ``ipc`` clips repeats its choices."""
    meta = store.meta
    device = torch.device(device)
    selector = SELECTORS[method]
    model = path_model(model_name, meta.channel, meta.num_classes,
                       tuple(meta.im_size), frames, generator=generator,
                       device=device)
    model.requires_grad_(False)
    if params is None:
        params = dict(model.named_parameters())
    params = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
    norm_mean, norm_std = norm_stats(meta, device)
    clips2d = store.device_clips(device)
    C = meta.num_classes
    picked = []
    for c in range(C):
        cls_idx = np.nonzero(store.labels == c)[0]
        feats = real_features(model, params, store, clips2d,
                              torch.as_tensor(cls_idx, device=device),
                              norm_mean, norm_std, torch.float32,
                              real_chunk(model, frames, meta.im_size, chunk))
        chosen = cls_idx[selector(feats.cpu().numpy(), min(ipc, len(cls_idx)))]
        while len(chosen) < ipc:  # degenerate tiny class
            chosen = np.concatenate([chosen, chosen[: ipc - len(chosen)]])
        picked.append(chosen)
    picked = np.concatenate(picked)
    syn = store.normalize(torch.as_tensor(np.asarray(store.clips[picked]),
                                          device=device))
    labels = torch.as_tensor(np.repeat(np.arange(C), ipc), dtype=torch.int64,
                             device=device)
    return syn, labels
