"""Packed video stores: containers, the device side and the on-disk format.

Port of ``video_distillation_tpu/data/store.py``: ``ClipStore`` (fixed
train clips, uploaded once as uint8 and gathered on the device),
``RaggedFrameStore`` (ragged test videos with the reference's temporal-crop
rules) and ``VideoData``, and the directory format that ``data/packer.py``
(and the JAX package's copy of it) writes. Row-sharding the clip store
over several devices (``shard_store``) is not ported (ROADMAP A.16).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from .meta import FRAME_GAP, DatasetMeta


def sample_start(rng: np.random.Generator, length: int, num_frames: int,
                 frame_gap: int = FRAME_GAP) -> Tuple[int, int]:
    """Reference temporal sampling (dataset.py:425-435), 0-indexed.

    Returns (start0, skip). The reference draws a 1-indexed start in
    [1, length - (F-1)*skip) over 1-indexed frame filenames; 0-indexed that
    is [0, length - (F-1)*skip - 1).
    """
    if length < num_frames * frame_gap:
        skip = max(1, length // num_frames)
    else:
        skip = frame_gap
    hi = length - (num_frames - 1) * skip - 1
    start = int(rng.integers(0, max(1, hi)))
    return start, skip


def clip_indices(start: int, skip: int, num_frames: int) -> np.ndarray:
    return np.arange(start, start + num_frames * skip, skip)[:num_frames]


def normalize_u8(x: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [0,255] clips (..., C) -> fp32 ``(x - 255·mean) / (255·std)``."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x.float() - m) / s


@dataclasses.dataclass
class ClipStore:
    """Fixed-shape clip tensor (the train split), uploaded to the device
    once for gathers there."""

    clips: np.ndarray  # (N, F, H, W, C) uint8 (or (N, H, W, C) for images)
    labels: np.ndarray  # (N,) int32
    meta: DatasetMeta

    def __post_init__(self):
        self.labels = np.asarray(self.labels, np.int32)
        self._device_clips = {}
        self._class_table = None

    def __len__(self):
        return self.clips.shape[0]

    @property
    def num_classes(self):
        return self.meta.num_classes

    @property
    def item_shape(self):
        return self.clips.shape[1:]

    def device_clips(self, device, sharded: bool = False) -> torch.Tensor:
        """The uint8 clips on ``device`` (cached per device), flattened to
        (N, prod(item_shape)); consumers reshape gathered rows back."""
        if sharded:
            raise NotImplementedError(
                "shard_store: row-sharding the clip store over several "
                "devices is not ported yet (ROADMAP A.16)")
        key = str(torch.device(device))
        if key not in self._device_clips:
            flat = np.ascontiguousarray(self.clips).reshape(len(self), -1)
            self._device_clips[key] = torch.from_numpy(flat).to(device)
        return self._device_clips[key]

    def gather_clips(self, clips2d: torch.Tensor, idx) -> torch.Tensor:
        """Gather rows from device_clips() -> (len(idx), *item_shape)."""
        return clips2d[idx].reshape((-1,) + tuple(self.item_shape))

    def class_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indices (C, max_count) padded with repeats, counts (C,))."""
        if self._class_table is None:
            C = self.num_classes
            groups = [np.nonzero(self.labels == c)[0] for c in range(C)]
            counts = np.array([len(g) for g in groups], np.int32)
            mx = max(1, int(counts.max()))
            table = np.zeros((C, mx), np.int32)
            for c, g in enumerate(groups):
                if len(g):
                    table[c, :len(g)] = g
                    table[c, len(g):] = g[0]
            self._class_table = (table, counts)
        return self._class_table

    def sample_per_class(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """(C, n) indices — n random distinct clips per class, matching the
        reference's ``get_images`` permutation draw
        (distill_baseline.py:84-90)."""
        table, counts = self.class_table()
        out = np.empty((self.num_classes, n), np.int64)
        for c in range(self.num_classes):
            cnt = int(counts[c])
            if cnt >= n:
                sel = rng.permutation(cnt)[:n]
            else:  # sample with replacement if the class is tiny
                sel = rng.integers(0, max(1, cnt), size=n)
            out[c] = table[c, sel]
        return out

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 [0,255] -> fp32, ToTensor + Normalize(mean, std)."""
        return normalize_u8(x, self.meta.mean, self.meta.std)


@dataclasses.dataclass
class RaggedFrameStore:
    """Host-resident ragged full-frame videos (the test split)."""

    frames: np.ndarray  # (total_frames, H, W, C) uint8 (may be a memmap)
    offsets: np.ndarray  # (N+1,) int64
    labels: np.ndarray  # (N,) int32
    meta: DatasetMeta

    def __len__(self):
        return len(self.labels)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def sample_clips(self, rng: np.random.Generator,
                     flip: bool = True) -> np.ndarray:
        """Draw one random temporal crop per video -> (N, F, H, W, C) uint8,
        with the reference's adaptive skip, fresh start per access and
        random per-clip hflip (dataset.py:398-435)."""
        F = self.meta.frames
        lengths = self.lengths()
        idx = np.empty((len(self), F), np.int64)
        for i, ln in enumerate(lengths):
            start, skip = sample_start(rng, int(ln), F)
            idx[i] = self.offsets[i] + np.clip(clip_indices(start, skip, F),
                                               0, ln - 1)
        clips = self.frames[idx.reshape(-1)].reshape(
            (len(self), F) + self.frames.shape[1:])
        if flip:
            do = rng.random(len(self)) > 0.5
            clips[do] = clips[do, :, :, ::-1]
        return clips


@dataclasses.dataclass
class VideoData:
    """A packed dataset: fixed train clips + ragged test videos."""

    meta: DatasetMeta
    train: ClipStore
    test: RaggedFrameStore


def save_packed(root: str, data: VideoData):
    """Write a packed dataset directory (meta.json + the five .npy files;
    ``store.py:203-212``)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "meta.json"), "w") as f:
        f.write(data.meta.to_json())
    np.save(os.path.join(root, "train_clips.npy"), data.train.clips)
    np.save(os.path.join(root, "train_labels.npy"), data.train.labels)
    np.save(os.path.join(root, "test_frames.npy"), data.test.frames)
    np.save(os.path.join(root, "test_offsets.npy"), data.test.offsets)
    np.save(os.path.join(root, "test_labels.npy"), data.test.labels)


def load_packed(root: str, mmap: bool = True) -> VideoData:
    """Read a packed dataset directory (meta.json + the five .npy files)."""
    with open(os.path.join(root, "meta.json")) as f:
        meta = DatasetMeta.from_json(f.read())
    mm = "r" if mmap else None
    train = ClipStore(
        clips=np.load(os.path.join(root, "train_clips.npy"), mmap_mode=mm),
        labels=np.load(os.path.join(root, "train_labels.npy")),
        meta=meta,
    )
    test = RaggedFrameStore(
        frames=np.load(os.path.join(root, "test_frames.npy"), mmap_mode=mm),
        offsets=np.load(os.path.join(root, "test_offsets.npy")),
        labels=np.load(os.path.join(root, "test_labels.npy")),
        meta=meta,
    )
    return VideoData(meta=meta, train=train, test=test)
