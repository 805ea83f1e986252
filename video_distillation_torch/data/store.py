"""Packed video stores: containers, the device side and the on-disk format.

Port of ``video_distillation_tpu/data/store.py``: ``ClipStore`` (fixed
train clips, uploaded once as uint8 and gathered on the device),
``RaggedFrameStore`` (ragged test videos with the reference's temporal-crop
rules) and ``VideoData``, and the directory format that ``data/packer.py``
(and the JAX package's copy of it) writes. Under a process group of n
ranks, ``device_clips(sharded=True)`` row-shards the clip store: each rank
holds ceil(N/n) rows (``ShardedClips``), and a gather of global indices is
a collective that fetches every row from its owner.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..parallel import dist
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


class ShardedClips:
    """This rank's rows of a flat (N, D) uint8 store row-sharded over the
    ranks: rows ``[r·R, (r+1)·R)`` with R = ceil(N/n), the last rank's
    padded with zero rows (the JAX package's ``P('data', None)`` store).
    No rank holds the whole store."""

    def __init__(self, flat: np.ndarray, device):
        n, r = dist.world_size(), dist.rank()
        self.total = flat.shape[0]
        self.rows_per_rank = -(-self.total // n)
        self.start = r * self.rows_per_rank
        mine = flat[self.start:self.start + self.rows_per_rank]
        self.local = torch.zeros((self.rows_per_rank, flat.shape[1]),
                                 dtype=torch.uint8, device=device)
        if len(mine):
            self.local[:len(mine)] = torch.from_numpy(
                np.ascontiguousarray(mine)).to(device)

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global indices < N, this rank's request) of the
        whole store. A collective: every rank calls it, each with its own
        request. The requests are summed into one table; each rank fills
        the requested rows it owns, and a SUM reduction (exact: one owner a
        row) hands each rank its rows."""
        n, r, dev = dist.world_size(), dist.rank(), self.local.device
        idx = torch.as_tensor(idx, device=dev).reshape(-1).long()
        lengths = torch.zeros(n, dtype=torch.long, device=dev)
        lengths[r] = idx.numel()
        dist.all_reduce_(lengths)
        longest = int(lengths.max())
        table = torch.zeros((n, longest), dtype=torch.long, device=dev)
        table[r, :idx.numel()] = idx + 1  # 0: no row
        dist.all_reduce_(table)
        want = table - 1 - self.start
        mine = (table > 0) & (want >= 0) & (want < self.rows_per_rank)
        rows = torch.zeros((n, longest, self.local.shape[1]),
                           dtype=torch.uint8, device=dev)
        rows[mine] = self.local[want[mine]]
        return dist.reduce_scatter(rows)[:idx.numel()]


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

    def device_clips(self, device, sharded: bool = False):
        """The uint8 clips on ``device`` (cached per device), flattened to
        (N, prod(item_shape)); consumers reshape gathered rows back. With
        ``sharded`` under a group of n > 1 ranks, this rank's ceil(N/n)
        rows (``ShardedClips``; the whole store at world size 1)."""
        key = (str(torch.device(device)),
               sharded and dist.world_size() > 1)
        if key not in self._device_clips:
            flat = np.asarray(self.clips).reshape(len(self), -1)
            self._device_clips[key] = (
                ShardedClips(flat, device) if key[1] else
                torch.from_numpy(np.ascontiguousarray(flat)).to(device))
        return self._device_clips[key]

    def gather_clips(self, clips2d, idx) -> torch.Tensor:
        """Gather rows from device_clips() -> (len(idx), *item_shape); from
        a ``ShardedClips``, a collective every rank calls."""
        rows = (clips2d.gather(idx) if isinstance(clips2d, ShardedClips)
                else clips2d[idx])
        return rows.reshape((-1,) + tuple(self.item_shape))

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
