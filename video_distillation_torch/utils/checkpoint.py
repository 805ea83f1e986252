"""Checkpoint / resume for distillation runs.

Port of ``video_distillation_tpu/utils/checkpoint.py`` (:28-134) without
orbax: the full distillation state (S2D tensors, momenta, ``syn_lr``,
``mom_lr``) goes to ``step_{n}.pt`` with ``torch.save``, and the iteration
and the host numpy RNG state to ``latest.json``, so a run resumes exactly.
Output artifacts (``images_{it}``, ``dynamic_{it}``, ``hal_{it}``) keep the
JAX package's ``.npy`` / ``.npz`` formats. Under a process group only the
coordinator (rank 0) writes (the JAX ``utils/checkpoint.py:38`` rule); the
state it writes is replicated, so no rank gathers anything for it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..parallel import dist


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_state(path: str, state: Any, step: int,
               host_rng: Optional[np.random.Generator] = None):
    """Save a nested dict/list of tensors + the host RNG; path is a
    directory. ``latest.json`` is written last, so a crash mid-save leaves
    the previous checkpoint current. Only the coordinator writes."""
    if not dist.is_coordinator():
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(_to_cpu(state), os.path.join(path, f"step_{step}.pt"))
    meta = {"step": step}
    if host_rng is not None:
        meta["rng_state"] = host_rng.bit_generator.state
    tmp = os.path.join(path, "latest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, "latest.json"))


def latest_step(path: str) -> Optional[int]:
    meta_path = os.path.join(path, "latest.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)["step"]


def restore_state(path: str, device=None):
    """Returns (state, step, rng_state | None), or None if there is no
    checkpoint; the tensors land on ``device``."""
    path = os.path.abspath(path)
    step = latest_step(path)
    if step is None:
        return None
    with open(os.path.join(path, "latest.json")) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, f"step_{step}.pt"),
                       map_location=device, weights_only=True)
    return state, step, meta.get("rng_state")


def save_artifact(path: str, name: str, array):
    """Reference-style output artifact (images_{it} etc.) as .npy, written
    by the coordinator."""
    if not dist.is_coordinator():
        return
    os.makedirs(path, exist_ok=True)
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    np.save(os.path.join(path, f"{name}.npy"), np.asarray(array))


def _keyed_leaves(tree, prefix=""):
    """(key, leaf) pairs keyed as ``jax.tree_util.keystr`` keys them
    (``[0]['kernel']``), so the files match the JAX package's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed_leaves(v, f"{prefix}[{i}]")
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        yield prefix, np.asarray(tree)


def save_pytree_artifact(path: str, name: str, tree: Any):
    """Nested dict/list artifact (e.g. hallucinator params in the JAX
    layout — hal_{it}.pt in the reference, distill_s2d_ms.py:175-193) as an
    .npz of path-keyed leaves, written by the coordinator."""
    if not dist.is_coordinator():
        return
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"{name}.npz"), **dict(_keyed_leaves(tree)))

