"""DC-lineage image datasets (MNIST..CIFAR100, ImageNet) and FRePo's image
sets (imagenette, imagewoof, tiny-imagenet) as packed stores.

Port of ``video_distillation_tpu/data/image_datasets.py``, numpy only (the
JAX module has no JAX in it; this is its copy): the image branches of the
reference's ``get_dataset`` (utils.py:26-123) with the channel, resolution
and normalisation constants of ``data/meta.py``. The train split is a 4-D
``(N, H, W, C)`` ``ClipStore`` of images; the test split a
``RaggedFrameStore`` of 1-frame videos (``frames=1``), so the evaluation
harness drives both data kinds. ``load_image_dataset`` reads its
``{name}_images.npz`` cache, or downloads through torchvision, imported
only there (so it raises ``ImportError`` where torchvision is absent);
the JPEG-tree loaders need PIL, imported where they decode.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from .meta import get_meta
from .store import ClipStore, RaggedFrameStore, VideoData


def _to_uint8_nhwc(x: np.ndarray, channel: int) -> np.ndarray:
    if x.ndim == 3:  # (N, H, W) grayscale
        x = x[..., None]
    if x.shape[1] == channel and x.shape[-1] != channel:  # NCHW -> NHWC
        x = np.transpose(x, (0, 2, 3, 1))
    if x.dtype != np.uint8:
        x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    return x


def load_image_dataset(name: str, data_path: str,
                       download: bool = True) -> VideoData:
    """Load via torchvision and pack; cached as .npz under data_path."""
    meta = get_meta(name)
    cache = os.path.join(data_path, f"{name}_images.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            xtr, ytr, xte, yte = (z["xtr"], z["ytr"], z["xte"], z["yte"])
    else:
        from torchvision import datasets

        os.makedirs(data_path, exist_ok=True)
        if name == "MNIST":
            tr = datasets.MNIST(data_path, train=True, download=download)
            te = datasets.MNIST(data_path, train=False, download=download)
            xtr, ytr = tr.data.numpy(), np.asarray(tr.targets)
            xte, yte = te.data.numpy(), np.asarray(te.targets)
        elif name == "FashionMNIST":
            tr = datasets.FashionMNIST(data_path, train=True,
                                       download=download)
            te = datasets.FashionMNIST(data_path, train=False,
                                       download=download)
            xtr, ytr = tr.data.numpy(), np.asarray(tr.targets)
            xte, yte = te.data.numpy(), np.asarray(te.targets)
        elif name in ("CIFAR10", "CIFAR100"):
            cls = getattr(datasets, name)
            tr = cls(data_path, train=True, download=download)
            te = cls(data_path, train=False, download=download)
            xtr, ytr = tr.data, np.asarray(tr.targets)
            xte, yte = te.data, np.asarray(te.targets)
        elif name == "SVHN":
            tr = datasets.SVHN(data_path, split="train", download=download)
            te = datasets.SVHN(data_path, split="test", download=download)
            xtr, ytr = np.transpose(tr.data, (0, 2, 3, 1)), tr.labels
            xte, yte = np.transpose(te.data, (0, 2, 3, 1)), te.labels
        else:
            raise ValueError(f"unsupported image dataset: {name}")
        xtr = _to_uint8_nhwc(np.asarray(xtr), meta.channel)
        xte = _to_uint8_nhwc(np.asarray(xte), meta.channel)
        np.savez_compressed(cache, xtr=xtr, ytr=ytr, xte=xte, yte=yte)

    train = ClipStore(xtr, np.asarray(ytr, np.int32), meta)
    n_test = xte.shape[0]
    test = RaggedFrameStore(
        frames=xte, offsets=np.arange(n_test + 1, dtype=np.int64),
        labels=np.asarray(yte, np.int32),
        meta=dataclasses.replace(meta, frames=1))
    return VideoData(meta=meta, train=train, test=test)


_IMAGENETTE_WNIDS = [
    "n01440764", "n02102040", "n02979186", "n03000684", "n03028079",
    "n03394916", "n03417042", "n03425413", "n03445777", "n03888257"]
_IMAGEWOOF_WNIDS = [
    "n02086240", "n02087394", "n02088364", "n02089973", "n02093754",
    "n02096294", "n02099601", "n02105641", "n02111889", "n02115641"]


def _load_jpeg_dir_split(split_dir: str, wnids, im_size) -> Tuple[
        np.ndarray, np.ndarray]:
    """Read <split_dir>/<wnid>/*.{JPEG,jpg,png} into (N,H,W,3) uint8."""
    from PIL import Image

    imgs, labels = [], []
    wnid_to_idx = {w: i for i, w in enumerate(sorted(wnids))}
    for wnid in sorted(wnids):
        d = os.path.join(split_dir, wnid)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if not f.lower().endswith((".jpeg", ".jpg", ".png")):
                continue
            img = Image.open(os.path.join(d, f)).convert("RGB")
            if img.size != (im_size[1], im_size[0]):
                img = img.resize((im_size[1], im_size[0]), Image.BILINEAR)
            imgs.append(np.asarray(img, np.uint8))
            labels.append(wnid_to_idx[wnid])
    x = (np.stack(imgs) if imgs
         else np.empty((0,) + tuple(im_size) + (3,), np.uint8))
    return x, np.asarray(labels, np.int32)


def _decode_one(job):
    """(path, label, im_size) -> (uint8 HWC image, label); module-level so
    multiprocessing.Pool can pickle it."""
    from PIL import Image

    path, label, im_size = job
    img = Image.open(path).convert("RGB")
    if img.size != (im_size[1], im_size[0]):
        # reference resize+center-crop (utils.py:121-124): shorter side
        # to im_size then crop the center
        w, h = img.size
        scale = max(im_size[1] / w, im_size[0] / h)
        img = img.resize((max(1, round(w * scale)),
                          max(1, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        x0 = (w - im_size[1]) // 2
        y0 = (h - im_size[0]) // 2
        img = img.crop((x0, y0, x0 + im_size[1], y0 + im_size[0]))
    return np.asarray(img, np.uint8), label


def load_imagenet(data_path: str, workers: int = 16) -> VideoData:
    """Full-ImageNet loader (the reference's ``utils.py:105-131``): prefer
    an already-resized ``imagenet_64x64`` directory next to ``data_path``,
    else resize+center-crop from the raw ``imagenet`` tree. Expects the
    standard extracted layout ``<root>/{train,val}/<wnid>/*.JPEG`` (the
    torch loader reads the same tree via ``datasets.ImageNet``). Decoding
    1.28M JPEGs is pooled across ``workers`` processes."""
    from multiprocessing import Pool

    meta = get_meta("ImageNet")
    h, w = meta.im_size
    resized = os.path.join(data_path, f"imagenet_{h}x{w}")
    root = resized if os.path.isdir(resized) else os.path.join(
        data_path, "imagenet")
    # per-split .npy cache: np.save streams the pre-allocated array to
    # disk without a compressed-zip staging copy (the train split alone is
    # ~16 GB uint8 at 1.28M images); the legacy single-npz cache is still
    # honoured if present
    cache_npz = os.path.join(data_path, "ImageNet_images.npz")
    cache_dir = os.path.join(data_path, "ImageNet_images")
    names = ("xtr", "ytr", "xte", "yte")
    if all(os.path.exists(os.path.join(cache_dir, f"{n}.npy"))
           for n in names):
        arrs = [np.load(os.path.join(cache_dir, f"{n}.npy"), mmap_mode="r")
                for n in names]
        return from_arrays("ImageNet", *arrs)
    if os.path.exists(cache_npz):
        with np.load(cache_npz) as z:
            return from_arrays("ImageNet", z["xtr"], z["ytr"], z["xte"],
                               z["yte"])

    wnids = sorted(d for d in os.listdir(os.path.join(root, "train"))
                   if os.path.isdir(os.path.join(root, "train", d)))
    wnid_to_idx = {wd: i for i, wd in enumerate(wnids)}
    splits = {}
    for split in ("train", "val"):
        jobs = []
        for wnid in wnids:
            d = os.path.join(root, split, wnid)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.lower().endswith((".jpeg", ".jpg", ".png")):
                    jobs.append((os.path.join(d, f), wnid_to_idx[wnid],
                                 meta.im_size))
        # pre-allocate the output array and fill it from a streaming
        # imap — peak RSS stays ~1x the split array instead of several
        # multiples (list-of-arrays + np.stack copy)
        xs = np.empty((len(jobs), h, w, 3), np.uint8)
        ys = np.empty(len(jobs), np.int32)
        if workers > 1 and len(jobs) > 64:
            with Pool(workers) as pool:
                for i, (img, label) in enumerate(
                        pool.imap(_decode_one, jobs, chunksize=256)):
                    xs[i], ys[i] = img, label
        else:
            for i, job in enumerate(jobs):
                xs[i], ys[i] = _decode_one(job)
        splits[split] = (xs, ys)
    os.makedirs(cache_dir, exist_ok=True)
    for n, arr in zip(names, (splits["train"][0], splits["train"][1],
                              splits["val"][0], splits["val"][1])):
        np.save(os.path.join(cache_dir, f"{n}.npy"), arr)
    return from_arrays("ImageNet", *splits["train"], *splits["val"])


def load_imagenette(root: str, name: str = "imagenette") -> VideoData:
    """Imagenette/Imagewoof builder over the extracted fast.ai archive
    layout (<root>/{train,val}/<wnid>/*.JPEG) — the TPU-native equivalent
    of the reference's tfds GeneratorBasedBuilder
    (FRePo/lib/dataset/imagenette.py, imagewoof.py)."""
    meta = get_meta(name)
    wnids = (_IMAGENETTE_WNIDS if name == "imagenette"
             else _IMAGEWOOF_WNIDS)
    xtr, ytr = _load_jpeg_dir_split(os.path.join(root, "train"), wnids,
                                    meta.im_size)
    xte, yte = _load_jpeg_dir_split(os.path.join(root, "val"), wnids,
                                    meta.im_size)
    return from_arrays(name, xtr, ytr, xte, yte)


def load_imagewoof(root: str) -> VideoData:
    return load_imagenette(root, name="imagewoof")


def load_tiny_imagenet(root: str) -> VideoData:
    """tiny-imagenet-200 layout: train/<wnid>/images/*.JPEG, val/images +
    val/val_annotations.txt (FRePo/lib/dataset/tinyimagenet.py)."""
    from PIL import Image

    meta = get_meta("tiny_imagenet")
    with open(os.path.join(root, "wnids.txt")) as f:
        wnids = sorted(line.strip() for line in f if line.strip())
    wnid_to_idx = {w: i for i, w in enumerate(wnids)}

    imgs, labels = [], []
    for wnid in wnids:
        d = os.path.join(root, "train", wnid, "images")
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            img = Image.open(os.path.join(d, f)).convert("RGB")
            imgs.append(np.asarray(img, np.uint8))
            labels.append(wnid_to_idx[wnid])
    xtr = np.stack(imgs)
    ytr = np.asarray(labels, np.int32)

    imgs, labels = [], []
    with open(os.path.join(root, "val", "val_annotations.txt")) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            fname, wnid = parts[0], parts[1]
            img = Image.open(os.path.join(root, "val", "images",
                                          fname)).convert("RGB")
            imgs.append(np.asarray(img, np.uint8))
            labels.append(wnid_to_idx[wnid])
    xte = np.stack(imgs)
    yte = np.asarray(labels, np.int32)
    return from_arrays("tiny_imagenet", xtr, ytr, xte, yte)


def write_preprocessed_shards(x: np.ndarray, y: np.ndarray, out_dir: str,
                              prefix: str, preprocess_op=None,
                              num_per_shard: int = 10000):
    """Sharded preprocessed-dataset writer — the npz equivalent of the
    reference's tfrecord write path (FRePo/lib/dataset/ops.py:349-437):
    apply a preprocess op (e.g. normalise + ZCA whitening) and write
    float32 shards + an index manifest.
    """
    import json

    os.makedirs(out_dir, exist_ok=True)
    n = x.shape[0]
    shard_lengths = []
    shard = 0
    for i in range(0, n, num_per_shard):
        xb = x[i:i + num_per_shard]
        if preprocess_op is not None:
            xb = np.asarray(preprocess_op(xb), np.float32)
        np.savez(os.path.join(out_dir, f"{prefix}-{shard:05d}.npz"),
                 x=xb, y=y[i:i + num_per_shard])
        shard_lengths.append(xb.shape[0])
        shard += 1
    with open(os.path.join(out_dir, f"{prefix}-index.json"), "w") as f:
        json.dump({"shard_lengths": shard_lengths, "total": n}, f)
    return shard_lengths


def load_preprocessed_shards(out_dir: str, prefix: str):
    """Read back all shards written by write_preprocessed_shards."""
    import json

    with open(os.path.join(out_dir, f"{prefix}-index.json")) as f:
        idx = json.load(f)
    xs, ys = [], []
    for shard in range(len(idx["shard_lengths"])):
        with np.load(os.path.join(out_dir,
                                  f"{prefix}-{shard:05d}.npz")) as z:
            xs.append(z["x"])
            ys.append(z["y"])
    return np.concatenate(xs), np.concatenate(ys)


def from_arrays(name: str, xtr, ytr, xte, yte) -> VideoData:
    """Build an image VideoData from in-memory arrays (tests)."""
    meta = get_meta(name)
    train = ClipStore(_to_uint8_nhwc(xtr, meta.channel),
                      np.asarray(ytr, np.int32), meta)
    n_test = xte.shape[0]
    test = RaggedFrameStore(
        frames=_to_uint8_nhwc(xte, meta.channel),
        offsets=np.arange(n_test + 1, dtype=np.int64),
        labels=np.asarray(yte, np.int32),
        meta=dataclasses.replace(meta, frames=1))
    return VideoData(meta=meta, train=train, test=test)
