"""Offline packer: reference frame-dir layouts -> packed uint8 stores.

A copy of ``video_distillation_tpu/data/packer.py`` (the port imports
nothing of the JAX package); both write the same bytes. One-time converters
from the exact on-disk layouts the reference consumes (its
``distill_utils/dataset.py``) into the packed format of ``store.py``:

* UCF101 / miniUCF101 / HMDB51: ``<root>/jpegs_112/<folder>/frame%06d.jpg``
  with CSV split files (header folder_name,label,split; dataset.py:365,
  :158, :253). miniUCF101 uses ``ucf50_splits1.csv`` (50-class subset).
* Kinetics400: ``<root>/{train,val}/<yid_start_end>/`` frame dirs from the
  extractor, with ``replacement/`` fallback and skip-on-missing
  (dataset.py:96-128).
* SSv2: ``annot_{split}.json`` lists of {id, label} over frame dirs
  (dataset.py:841-895).

Train splits are packed as fixed clips (one temporal start drawn at pack
time — the reference caches the start per index anyway, dataset.py:432-435);
test splits keep all frames (ragged) so each evaluation pass can draw fresh
temporal crops. The image datasets (ImageNet, MNIST, CIFAR, SVHN) need
``data/image_datasets.py``, which is not ported yet (ROADMAP A.15).
"""

from __future__ import annotations

import csv
import json
import os
import os.path as osp
from typing import List, Sequence, Tuple

import numpy as np

from .meta import DatasetMeta, get_meta
from .store import (ClipStore, RaggedFrameStore, VideoData, clip_indices,
                    sample_start, save_packed)

try:  # PIL ships with torchvision in this image
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


# ---------------------------------------------------------------------------
# layout readers: -> list of (frame_paths, label)
# ---------------------------------------------------------------------------

def _listdir_frames(d: str) -> List[str]:
    return [osp.join(d, f) for f in sorted(os.listdir(d))]


def read_ucf_csv(root: str, csv_name: str, split: str):
    """UCF/HMDB CSV layout (dataset.py:353-393). Frame files are
    frame%06d.jpg, 1-indexed."""
    data_path = osp.join(root, "jpegs_112")
    videos, label_strs = [], []
    with open(osp.join(root, csv_name)) as fp:
        for item in csv.DictReader(fp):
            if item["split"] != split:
                continue
            videos.append(osp.join(data_path, item["folder_name"]))
            label_strs.append(item["label"])
    classes = sorted(set(label_strs))
    class_2_idx = {x: i for i, x in enumerate(classes)}
    labels = [class_2_idx[s] for s in label_strs]
    return videos, labels, classes


def read_ucf_max_csv(root: str, split: str,
                     csv_name: str = "ucf50_splits1_max.csv"):
    """staticUCF50 feature-based temporal segment splits
    (dataset.py:739-782): CSV rows carry a ``split_index`` column with the
    segment boundary frames (a stringified int list) per video."""
    data_path = osp.join(root, "jpegs_112")
    videos, label_strs, seg_lists = [], [], []
    with open(osp.join(root, csv_name)) as fp:
        for item in csv.DictReader(fp):
            if item["split"] != split:
                continue
            videos.append(osp.join(data_path, item["folder_name"]))
            label_strs.append(item["label"])
            si = item["split_index"].strip("][").split(", ")
            seg_lists.append(sorted(int(i) for i in si))
    classes = sorted(set(label_strs))
    class_2_idx = {x: i for i, x in enumerate(classes)}
    labels = [class_2_idx[s] for s in label_strs]
    return videos, labels, classes, seg_lists


def segment_start_range(split_mode: str, split_id: int, split_num: int,
                        length: int, seg: Sequence[int]) -> Tuple[int, int]:
    """1-indexed [lo, hi) random-start bounds for one temporal segment
    (dataset.py:820-830). 'mean' slices the video evenly; 'feature' uses
    the per-video boundary frames from the max-csv."""
    if split_mode == "mean":
        return (length // split_num * split_id + 1,
                length // split_num * (split_id + 1))
    if split_mode != "feature":
        raise ValueError(f"unknown split_mode: {split_mode}")
    if split_id == 0:
        return 1, seg[0] + 1
    if split_id == split_num - 1:
        return seg[split_num - 2] + 1, length
    return seg[split_id - 1] + 1, seg[split_id] + 1


def read_kinetics_csv(root: str, split: str, num_frames: int):
    """K400 CSV with replacement-dir fallback (dataset.py:96-128)."""
    csv_split = "validate" if split == "val" else split
    videos, label_strs, skipped = [], [], 0
    with open(osp.join(root, f"{csv_split}.csv")) as fp:
        for item in csv.DictReader(fp):
            name = "%s_%06d_%06d" % (item["youtube_id"],
                                     int(item["time_start"]),
                                     int(item["time_end"]))
            d = osp.join(root, split, name)
            if not osp.exists(d) or len(os.listdir(d)) != num_frames:
                d = osp.join(root, "replacement", name)
            if not osp.exists(d) or len(os.listdir(d)) != num_frames:
                skipped += 1
                continue
            videos.append(d)
            label_strs.append(item["label"])
    classes = sorted(set(label_strs))
    class_2_idx = {x: i for i, x in enumerate(classes)}
    labels = [class_2_idx[s] for s in label_strs]
    return videos, labels, classes


def read_ssv2_json(root: str, split: str):
    """SSv2 annot_{split}.json + class_list.json (dataset.py:841-895)."""
    with open(osp.join(root, "class_list.json")) as f:
        classes = json.load(f)
    class_2_idx = {x: i for i, x in enumerate(classes)}
    with open(osp.join(root, f"annot_{split}.json")) as f:
        annots = json.load(f)
    videos, labels = [], []
    for a in annots:
        d = osp.join(root, split, str(a["id"]))
        if not osp.isdir(d):
            continue
        videos.append(d)
        labels.append(class_2_idx[a["label"]])
    return videos, labels, classes


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _load_frame(path: str, im_size) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    if img.size != (im_size[1], im_size[0]):
        img = img.resize((im_size[1], im_size[0]), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def _frame_path(video_dir: str, i0: int, naming: str) -> str:
    if naming == "ucf":  # frame%06d.jpg, 1-indexed
        return osp.join(video_dir, "frame%06d.jpg" % (i0 + 1))
    # generic: sorted listing
    raise ValueError(naming)


def _pack_one_clip(job):
    """(video_dir, F, naming, im_size) -> (F, H, W, 3) uint8 with the
    temporal start pre-drawn in the parent (RNG stays deterministic and
    independent of worker count); module-level for Pool picklability."""
    d, idx, naming, im_size = job
    files = None if naming == "ucf" else sorted(os.listdir(d))
    out = np.empty((len(idx),) + tuple(im_size) + (3,), np.uint8)
    for fi, i0 in enumerate(idx):
        if naming == "ucf":
            p = _frame_path(d, int(i0), naming)
        else:
            p = osp.join(d, files[int(i0)])
        out[fi] = _load_frame(p, im_size)
    return out


def _pack_one_video_frames(job):
    """(video_dir, naming, max_frames, im_size) -> (n, H, W, 3) uint8."""
    d, naming, max_frames, im_size = job
    files = sorted(os.listdir(d))[:max_frames]
    out = np.empty((len(files),) + tuple(im_size) + (3,), np.uint8)
    for fi, f in enumerate(files):
        if naming == "ucf":
            p = _frame_path(d, fi, naming)
        else:
            p = osp.join(d, f)
        out[fi] = _load_frame(p, im_size)
    return out


def _pool_map(fn, jobs, workers: int):
    """Pooled map matching the reference extractors' multiprocessing.Pool
    (extract_k400.py:82-87); serial for small job lists / workers<=1.
    Workers are spawned, not forked: a fork of a process with threads
    (torch's) can deadlock."""
    if workers > 1 and len(jobs) > 8:
        from multiprocessing import get_context

        with get_context("spawn").Pool(workers) as pool:
            return pool.map(fn, jobs, chunksize=8)
    return [fn(j) for j in jobs]


def pack_train_clips(videos: Sequence[str], labels: Sequence[int],
                     meta: DatasetMeta, rng: np.random.Generator,
                     naming: str = "ucf", workers: int = 8) -> ClipStore:
    F = meta.frames
    jobs = []
    for d in videos:
        length = len(os.listdir(d))
        start, skip = sample_start(rng, length, F)
        idx = np.clip(clip_indices(start, skip, F), 0, length - 1)
        jobs.append((d, idx, naming, meta.im_size))
    loaded = _pool_map(_pack_one_clip, jobs, workers)
    clips = (np.stack(loaded) if loaded else
             np.empty((0, F) + meta.im_size + (3,), np.uint8))
    return ClipStore(clips, np.asarray(labels, np.int32), meta)


def pack_test_frames(videos: Sequence[str], labels: Sequence[int],
                     meta: DatasetMeta, max_frames: int = 300,
                     naming: str = "ucf", workers: int = 8
                     ) -> RaggedFrameStore:
    jobs = [(d, naming, max_frames, meta.im_size) for d in videos]
    loaded = _pool_map(_pack_one_video_frames, jobs, workers)
    lengths = [x.shape[0] for x in loaded]
    offsets = np.zeros(len(videos) + 1, np.int64)
    offsets[1:] = np.cumsum(lengths)
    frames = (np.concatenate(loaded) if loaded else
              np.empty((0,) + meta.im_size + (3,), np.uint8))
    return RaggedFrameStore(frames, offsets, np.asarray(labels, np.int32),
                            meta)


def pack_static_segments(videos: Sequence[str], labels: Sequence[int],
                         seg_lists: Sequence[Sequence[int]],
                         meta: DatasetMeta, rng: np.random.Generator,
                         split_mode: str, split_id: int,
                         split_num: int = 4) -> ClipStore:
    """staticUCF50 segment variant: one random frame drawn INSIDE the
    video's temporal segment ``split_id``, repeated F times ("boring
    video") — dataset.py:783-833."""
    F = meta.frames
    clips = np.empty((len(videos), F) + meta.im_size + (3,), np.uint8)
    for vi, d in enumerate(videos):
        length = len(os.listdir(d))
        lo, hi = segment_start_range(split_mode, split_id, split_num,
                                     length, seg_lists[vi])
        lo = max(1, min(lo, length))
        hi = max(lo + 1, min(hi, length + 1))
        start1 = int(rng.integers(lo, hi))  # 1-indexed frame number
        frame = _load_frame(
            osp.join(d, "frame%06d.jpg" % start1), meta.im_size)
        clips[vi] = frame[None]
    return ClipStore(clips, np.asarray(labels, np.int32), meta)


def pack_dataset(dataset: str, data_path: str, out_root: str,
                 seed: int = 0, split_mode: str = None,
                 split_id: int = 0, split_num: int = 4) -> str:
    """Pack a reference-layout dataset; returns the packed dir path.

    ``split_mode`` ('mean' | 'feature') activates the staticUCF50 temporal
    segment variant: the static frame is drawn from segment ``split_id``
    of each video (feature mode needs ucf50_splits1_max.csv)."""
    meta = get_meta(dataset)
    rng = np.random.default_rng(seed)

    if dataset == "staticUCF50" and split_mode is not None:
        root = osp.join(data_path, "UCF101")
        trv, trl, _, trseg = read_ucf_max_csv(root, "train")
        tev, tel, _, _ = read_ucf_max_csv(root, "test")
        train = pack_static_segments(trv, trl, trseg, meta, rng,
                                     split_mode, split_id, split_num)
        test = pack_test_frames(tev, tel, meta, naming="ucf")
        out = osp.join(out_root,
                       f"{dataset}_{split_mode}{split_id}_packed")
        save_packed(out, VideoData(meta=meta, train=train, test=test))
        return out

    if dataset in ("UCF101", "miniUCF101", "staticUCF50", "staticUCF101"):
        root = osp.join(data_path, "UCF101")
        csv_name = ("ucf50_splits1.csv"
                    if dataset in ("miniUCF101", "staticUCF50")
                    else "ucf101_splits1.csv")
        naming = "ucf"
        tr = read_ucf_csv(root, csv_name, "train")
        te = read_ucf_csv(root, csv_name, "test")
    elif dataset in ("HMDB51", "staticHMDB51"):
        root = osp.join(data_path, "HMDB51")
        naming = "ucf"
        tr = read_ucf_csv(root, "hmdb51_splits.csv", "train")
        te = read_ucf_csv(root, "hmdb51_splits.csv", "test")
    elif dataset in ("Kinetics400", "staticKinetics400"):
        root = osp.join(data_path, "Kinetics")
        naming = "listing"
        tr = read_kinetics_csv(root, "train", meta.frames)
        te = read_kinetics_csv(root, "val", meta.frames)
    elif dataset in ("SSv2", "staticSSv2"):
        root = osp.join(data_path, "SSv2")
        naming = "listing"
        tr = read_ssv2_json(root, "train")
        te = read_ssv2_json(root, "val")
    elif dataset in ("ImageNet", "MNIST", "FashionMNIST", "SVHN", "CIFAR10",
                     "CIFAR100"):
        raise NotImplementedError(
            f"pack_dataset: {dataset} needs data/image_datasets.py, which is "
            "not ported yet (ROADMAP A.15)")
    else:
        raise ValueError(f"pack_dataset: unsupported dataset {dataset}")

    train = pack_train_clips(tr[0], tr[1], meta, rng, naming=naming)
    test = pack_test_frames(te[0], te[1], meta, naming=naming)
    if dataset.startswith("static"):
        # boring videos: one random frame repeated F times
        # (dataset.py:570-839)
        pick = rng.integers(0, meta.frames, size=len(train))
        train.clips = np.repeat(
            train.clips[np.arange(len(train)), pick][:, None],
            meta.frames, axis=1)
    out = osp.join(out_root, f"{dataset}_packed")
    save_packed(out, VideoData(meta=meta, train=train, test=test))
    return out
