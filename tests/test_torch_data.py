"""The port's copies of the JAX package's jax-free modules agree with it:
config presets, dataset metadata, synthetic data, the packed-store format,
the test split's crop rules and the artifact files. All numpy, so exact."""

import dataclasses

import numpy as np
import pytest
import torch

from video_distillation_tpu import config as jconfig
from video_distillation_tpu.data import meta as jmeta
from video_distillation_tpu.data import store as jstore
from video_distillation_tpu.data.synthetic import \
    make_synthetic_video_data as jax_synthetic
from video_distillation_tpu.utils import checkpoint as jckpt
from video_distillation_tpu.utils import visualize as jvis
from video_distillation_torch import config as tconfig
from video_distillation_torch.data import meta as tmeta
from video_distillation_torch.data.store import load_packed
from video_distillation_torch.data.synthetic import \
    make_synthetic_video_data as torch_synthetic
from video_distillation_torch.utils import checkpoint as tckpt
from video_distillation_torch.utils import visualize as tvis

PRESETS = sorted(jconfig._PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    j = dataclasses.asdict(jconfig.get_preset(name))
    t = dataclasses.asdict(tconfig.get_preset(name))
    # the port's only extra field picks the device, CUDA unless asked
    assert t.pop("device", "cuda") == "cuda"
    assert t == j


def test_dataset_metadata_matches_jax():
    # synthetic sets register themselves when made, in one package or the
    # other, by whichever tests ran earlier in this process
    builtin = lambda reg: sorted(n for n in reg if not n.startswith("synthetic"))
    assert builtin(jmeta._REGISTRY) == builtin(tmeta._REGISTRY)
    for name in builtin(jmeta._REGISTRY):
        assert jmeta.get_meta(name).to_json() == tmeta.get_meta(name).to_json()


def _same_store(a, b):
    assert a.meta.to_json() == b.meta.to_json()
    for x, y in ((a.train.clips, b.train.clips), (a.train.labels, b.train.labels),
                 (a.test.frames, b.test.frames), (a.test.offsets, b.test.offsets),
                 (a.test.labels, b.test.labels)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_synthetic_data_and_packed_store_match_jax(tmp_path):
    kw = dict(num_classes=3, clips_per_class=2, test_per_class=2, frames=4,
              im_size=(16, 16), seed=3, name="synthetic_parity")
    jdata, tdata = jax_synthetic(**kw), torch_synthetic(**kw)
    _same_store(jdata, tdata)
    jstore.save_packed(str(tmp_path), jdata)
    _same_store(jdata, load_packed(str(tmp_path)))
    # the test split's temporal crops and flips, from the same seed
    a = jdata.test.sample_clips(np.random.default_rng(9))
    b = tdata.test.sample_clips(np.random.default_rng(9))
    assert np.array_equal(a, b)


def test_artifacts_are_the_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    hals = [{"kernel": rng.normal(size=(3, 3, 3, 4, 3)).astype(np.float32),
             "bias": rng.normal(size=(3,)).astype(np.float32)}]
    dyn = rng.normal(size=(4, 2, 8, 8, 1)).astype(np.float32)
    jckpt.save_pytree_artifact(str(tmp_path / "j"), "hal_0", hals)
    jckpt.save_artifact(str(tmp_path / "j"), "dynamic_0", dyn)
    tckpt.save_pytree_artifact(
        str(tmp_path / "t"), "hal_0",
        [{k: torch.from_numpy(v) for k, v in hals[0].items()}])
    tckpt.save_artifact(str(tmp_path / "t"), "dynamic_0", torch.from_numpy(dyn))
    with np.load(tmp_path / "j" / "hal_0.npz") as j, \
            np.load(tmp_path / "t" / "hal_0.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert np.array_equal(j[k], t[k])
    assert np.array_equal(np.load(tmp_path / "j" / "dynamic_0.npy"),
                          np.load(tmp_path / "t" / "dynamic_0.npy"))


def _read_png(path):
    """Decode an 8-bit RGB PNG whose scanlines use filter type 0."""
    import struct
    import zlib
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
            assert body[8:] == bytes([8, 2, 0, 0, 0])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_grids_match_jax_and_decode(tmp_path):
    rng = np.random.default_rng(0)
    static = rng.normal(size=(4, 10, 12, 3)).astype(np.float32)
    dynamic = rng.normal(size=(2, 2, 6, 10, 12, 1)).astype(np.float32)
    mean, std = tmeta.IMAGENET_MEAN, tmeta.IMAGENET_STD
    paths = tvis.save_s2d_grids(str(tmp_path), 7, static=static,
                                dynamic=dynamic, videos=dynamic[0].repeat(3, -1),
                                mean=mean, std=std)
    assert [p.split("/")[-1] for p in paths] == [
        "static_000007.png", "dynamic_000007.png", "videos_000007.png"]
    want = jvis._to_grid(jvis.scale_for_vis(static, mean, std), 10)
    np.testing.assert_array_equal(tvis._to_grid(tvis.scale_for_vis(
        static, mean, std), 10), want)
    np.testing.assert_array_equal(_read_png(paths[0]), want)
    dyn = dynamic.reshape((-1,) + dynamic.shape[-4:])
    flat = dyn[:, ::1][:, :8].reshape((-1,) + dyn.shape[2:])
    np.testing.assert_array_equal(
        _read_png(paths[1]), jvis._to_grid(jvis.scale_for_vis(flat), 6))
