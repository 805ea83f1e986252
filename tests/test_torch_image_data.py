"""The port's image datasets (``data/image_datasets.py``) and the packer's
image branch against the JAX package's, on the CPU.

The inputs are written by the tests from a numpy seed: in-memory arrays
(3 classes, 32x32), the ``{name}_images.npz`` and ``ImageNet_images/``
caches, and JPEG trees in the ImageNet, imagenette/imagewoof and
tiny-imagenet layouts (PIL, as ``tests/test_image_builders.py`` writes
them). Every array the port gives must equal the JAX function's byte for
byte; nothing is downloaded.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
from PIL import Image

from video_distillation_tpu.data import image_datasets as jimg
from video_distillation_tpu.data import packer as jpacker
from video_distillation_tpu.data.meta import DatasetMeta as JaxMeta
from video_distillation_tpu.data.meta import register_meta as jax_register
from video_distillation_tpu.data.store import load_packed as jax_load_packed
from video_distillation_torch.data import image_datasets as timg
from video_distillation_torch.data import packer as tpacker
from video_distillation_torch.data.meta import DatasetMeta, register_meta
from video_distillation_torch.data.store import load_packed

NC, IM = 3, 32
TINY = "img-tiny"



def _register():
    for reg, meta in ((jax_register, JaxMeta), (register_meta, DatasetMeta)):
        reg(meta(TINY, 3, (IM, IM), NC, (0.485, 0.456, 0.406),
                 (0.229, 0.224, 0.225)))


def image_arrays(train_per_class=8, test_per_class=4, seed=0):
    """(xtr, ytr, xte, yte): uint8 32x32x3 images, class means plus noise
    (the JAX package's ``test_image_store_and_raw_frepo`` recipe)."""
    rng = np.random.default_rng(seed)
    mu = rng.integers(40, 215, size=(NC, 3))

    def split(n):
        y = np.repeat(np.arange(NC), n)
        x = np.clip(mu[y][:, None, None, :] +
                    rng.normal(0, 25, (NC * n, IM, IM, 3)), 0, 255)
        return x.astype(np.uint8), y
    return (*split(train_per_class), *split(test_per_class))


def image_data(**kw):
    """(JAX VideoData, port VideoData) of one image set through each
    package's ``from_arrays``."""
    _register()
    arrays = image_arrays(**kw)
    return jimg.from_arrays(TINY, *arrays), timg.from_arrays(TINY, *arrays)


def assert_same_data(port, ref):
    assert port.meta == ref.meta or port.meta.to_json() == ref.meta.to_json()
    for a, b in ((port.train.clips, ref.train.clips),
                 (port.train.labels, ref.train.labels),
                 (port.test.frames, ref.test.frames),
                 (port.test.offsets, ref.test.offsets),
                 (port.test.labels, ref.test.labels)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert port.test.meta.frames == ref.test.meta.frames == 1


def test_from_arrays_is_the_jax_store():
    jdata, tdata = image_data()
    assert_same_data(tdata, jdata)
    assert tdata.train.clips.shape == (NC * 8, IM, IM, 3)
    clips = tdata.test.sample_clips(np.random.default_rng(0), flip=False)
    ref = jdata.test.sample_clips(np.random.default_rng(0), flip=False)
    assert clips.shape == (NC * 4, 1, IM, IM, 3)
    np.testing.assert_array_equal(clips, ref)


@pytest.mark.parametrize("layout", ["nhwc_u8", "nchw_float", "gray"])
def test_to_uint8_nhwc(layout):
    rng = np.random.default_rng(1)
    x = {"nhwc_u8": rng.integers(0, 256, (4, 8, 8, 3)).astype(np.uint8),
         "nchw_float": rng.random((4, 3, 8, 8)).astype(np.float32),
         "gray": rng.integers(0, 256, (4, 8, 8)).astype(np.uint8)}[layout]
    channel = 1 if layout == "gray" else 3
    got = timg._to_uint8_nhwc(x, channel)
    np.testing.assert_array_equal(got, jimg._to_uint8_nhwc(x, channel))
    assert got.dtype == np.uint8 and got.shape[-1] == channel


@pytest.mark.parametrize("name", ["CIFAR10", "MNIST"])
def test_image_dataset_npz_cache(tmp_path, name):
    """The cache branch of ``load_image_dataset``: a
    ``{name}_images.npz`` the test writes, NHWC uint8 as the loader writes
    it (MNIST's (N, 28, 28, 1))."""
    rng = np.random.default_rng(2)
    shape = (28, 28, 1) if name == "MNIST" else (IM, IM, 3)
    z = dict(xtr=rng.integers(0, 256, (12,) + shape).astype(np.uint8),
             ytr=rng.integers(0, 10, 12), xte=rng.integers(
                 0, 256, (5,) + shape).astype(np.uint8),
             yte=rng.integers(0, 10, 5))
    np.savez_compressed(tmp_path / f"{name}_images.npz", **z)
    got = timg.load_image_dataset(name, str(tmp_path))
    assert_same_data(got, jimg.load_image_dataset(name, str(tmp_path)))
    assert got.train.clips.ndim == 4


def test_image_dataset_without_cache_needs_torchvision(tmp_path,
                                                       monkeypatch):
    """Without its cache the loader downloads through torchvision, imported
    only there (the module imports without it); where torchvision is
    absent that import raises."""
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(ImportError):
        timg.load_image_dataset("CIFAR10", str(tmp_path), download=False)


def _write_jpegs(d, n, size, value):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        arr = np.full((size[0], size[1], 3), value, np.uint8)
        arr[::3, ::2] = 255 - value  # texture, so a resize shows
        Image.fromarray(arr).save(osp.join(d, f"img_{i:03d}.JPEG"))


def test_imagenet_loader_and_caches(tmp_path):
    """``load_imagenet`` over a fabricated ``imagenet_64x64`` tree (one
    class at 64x64, two resized and centre-cropped from 96x80), then from
    the per-split ``.npy`` cache directory it wrote, then from the old
    ``.npz`` cache alone."""
    root = tmp_path / "port"
    wnids = [f"n{i:08d}" for i in range(3)]
    for split, n in (("train", 2), ("val", 1)):
        for ci, wnid in enumerate(wnids):
            _write_jpegs(osp.join(root, "imagenet_64x64", split, wnid), n,
                         (64, 64) if ci == 0 else (96, 80), 30 * ci + 7)
    got = timg.load_imagenet(str(root), workers=1)
    cache = root / "ImageNet_images"
    assert sorted(os.listdir(cache)) == ["xte.npy", "xtr.npy", "yte.npy",
                                         "ytr.npy"]
    os.rename(cache, tmp_path / "port_cache")  # JAX decodes the tree too
    assert_same_data(got, jimg.load_imagenet(str(root), workers=1))
    assert got.train.clips.shape == (6, 64, 64, 3)
    assert_same_data(timg.load_imagenet(str(root), workers=1), got)
    arrs = {n: np.load(cache / f"{n}.npy") for n in ("xtr", "ytr", "xte",
                                                     "yte")}
    for n, a in arrs.items():
        np.testing.assert_array_equal(
            np.load(tmp_path / "port_cache" / f"{n}.npy"), a)
    old = tmp_path / "old"
    old.mkdir()
    np.savez(old / "ImageNet_images.npz", **arrs)
    assert_same_data(timg.load_imagenet(str(old)), got)


@pytest.mark.parametrize("name", ["imagenette", "imagewoof"])
def test_imagenette_and_imagewoof(tmp_path, name):
    wnids = (jimg._IMAGENETTE_WNIDS if name == "imagenette"
             else jimg._IMAGEWOOF_WNIDS)
    assert wnids == (timg._IMAGENETTE_WNIDS if name == "imagenette"
                     else timg._IMAGEWOOF_WNIDS)
    for split, n in (("train", 2), ("val", 1)):
        for ci, wnid in enumerate(wnids[:3]):
            _write_jpegs(osp.join(tmp_path, split, wnid), n, (24, 20),
                         10 * ci + 5)
    load = timg.load_imagenette if name == "imagenette" else timg.load_imagewoof
    ref = (jimg.load_imagenette if name == "imagenette"
           else jimg.load_imagewoof)(str(tmp_path))
    got = load(str(tmp_path))
    assert_same_data(got, ref)
    assert got.train.clips.shape == (6, 128, 128, 3)


def test_tiny_imagenet(tmp_path):
    wnids = [f"n{i:08d}" for i in range(3)]
    (tmp_path / "wnids.txt").write_text("\n".join(wnids))
    for ci, wnid in enumerate(wnids):
        _write_jpegs(osp.join(tmp_path, "train", wnid, "images"), 2, (64, 64),
                     20 * ci + 3)
    os.makedirs(tmp_path / "val" / "images")
    lines = []
    for i, wnid in enumerate(reversed(wnids)):
        fn = f"val_{i}.JPEG"
        Image.fromarray(np.full((64, 64, 3), 20 * i + 3, np.uint8)).save(
            tmp_path / "val" / "images" / fn)
        lines.append(f"{fn}\t{wnid}\t0\t0\t0\t0")
    (tmp_path / "val" / "val_annotations.txt").write_text("\n".join(lines))
    got = timg.load_tiny_imagenet(str(tmp_path))
    assert_same_data(got, jimg.load_tiny_imagenet(str(tmp_path)))
    assert got.test.labels.tolist() == [2, 1, 0]


def test_preprocessed_shards_round_trip_across_packages(tmp_path):
    """Shards written by either package read back equal by both, with a
    preprocess op applied per shard."""
    rng = np.random.default_rng(3)
    x = rng.random((25, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, NC, 25)
    op = lambda v: v * 2.0 - 1.0  # noqa: E731
    lens = timg.write_preprocessed_shards(x, y, str(tmp_path / "p"), "train",
                                          op, num_per_shard=10)
    jlens = jimg.write_preprocessed_shards(x, y, str(tmp_path / "j"),
                                           "train", op, num_per_shard=10)
    assert lens == jlens == [10, 10, 5]
    for d in ("p", "j"):
        with open(tmp_path / d / "train-index.json") as f:
            assert json.load(f) == {"shard_lengths": [10, 10, 5], "total": 25}
        for load in (timg.load_preprocessed_shards,
                     jimg.load_preprocessed_shards):
            xs, ys = load(str(tmp_path / d), "train")
            np.testing.assert_array_equal(xs, op(x))
            np.testing.assert_array_equal(ys, y)


def _packed_arrays(out):
    return {f: np.load(osp.join(out, f)) for f in sorted(os.listdir(out))
            if f.endswith(".npy")}


@pytest.mark.parametrize("name", ["CIFAR10", "ImageNet"])
def test_packer_image_branch(tmp_path, name):
    """``pack_dataset`` writes the JAX packer's store for an image dataset
    (from its cache), and the port's ``load_packed`` reads it back."""
    rng = np.random.default_rng(4)
    shape = (IM, IM, 3) if name == "CIFAR10" else (64, 64, 3)
    arrs = dict(xtr=rng.integers(0, 256, (9,) + shape).astype(np.uint8),
                ytr=np.arange(9) % 3,
                xte=rng.integers(0, 256, (4,) + shape).astype(np.uint8),
                yte=np.arange(4) % 3)
    src = tmp_path / "src"
    if name == "CIFAR10":
        src.mkdir()
        np.savez_compressed(src / "CIFAR10_images.npz", **arrs)
    else:
        (src / "ImageNet_images").mkdir(parents=True)
        for k, a in arrs.items():
            np.save(src / "ImageNet_images" / f"{k}.npy", a)
    out = tpacker.pack_dataset(name, str(src), str(tmp_path / "port"))
    ref = jpacker.pack_dataset(name, str(src), str(tmp_path / "jax"))
    assert osp.basename(out) == osp.basename(ref) == f"{name}_packed"
    got, want = _packed_arrays(out), _packed_arrays(ref)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with open(osp.join(out, "meta.json")) as a, \
            open(osp.join(ref, "meta.json")) as b:
        assert a.read() == b.read()
    data = load_packed(out)
    assert_same_data(data, jax_load_packed(ref))
    np.testing.assert_array_equal(data.train.clips, arrs["xtr"])
