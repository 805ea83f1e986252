"""Packed video stores: the numpy containers and the on-disk format.

Port of the host-side part of ``video_distillation_tpu/data/store.py``:
``ClipStore`` (fixed train clips), ``RaggedFrameStore`` (ragged test
videos with the reference's temporal-crop rules) and ``VideoData``, read
from the directory that ``video_distillation_tpu/data/packer.py`` writes.
Uploading the clip store to the device and gathering from it there is not
ported yet (the DM and buffer slices need it).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

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


@dataclasses.dataclass
class ClipStore:
    """Fixed-shape clip tensor (the train split)."""

    clips: np.ndarray  # (N, F, H, W, C) uint8 (or (N, H, W, C) for images)
    labels: np.ndarray  # (N,) int32
    meta: DatasetMeta

    def __post_init__(self):
        self.labels = np.asarray(self.labels, np.int32)

    def __len__(self):
        return self.clips.shape[0]

    @property
    def num_classes(self):
        return self.meta.num_classes

    @property
    def item_shape(self):
        return self.clips.shape[1:]


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
