"""The port's offline packer against the JAX package's, on fabricated
frame-dir trees (the reference's on-disk layouts, as
``tests/test_packer_ingest.py`` builds them).

Both packers, from the same tree and seed, must write byte-equal stores:
the five arrays and ``meta.json``. Each package's ``load_packed`` reads
the other's output. The port's pack driver runs as a module on the CPU.
"""

import csv
import json
import os
import os.path as osp
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image

from video_distillation_tpu.data import packer as jpacker
from video_distillation_tpu.data import store as jstore
from video_distillation_tpu.ingest.extract_ssv2 import \
    evenly_spaced as jax_evenly_spaced
from video_distillation_torch.data import packer, store
from video_distillation_torch.config import DistillConfig
from video_distillation_torch.data.meta import DatasetMeta
from video_distillation_torch.drivers.common import load_data
from video_distillation_torch.ingest import evenly_spaced

ROOT = Path(__file__).resolve().parent.parent
FILES = ("train_clips.npy", "train_labels.npy", "test_frames.npy",
         "test_offsets.npy", "test_labels.npy")


def _frames(d, n, size, rng, name="frame%06d.jpg", start=1):
    os.makedirs(d)
    for fi in range(start, start + n):
        arr = rng.integers(0, 255, (size, size, 3)).astype(np.uint8)
        Image.fromarray(arr).save(osp.join(d, name % fi))


def _ucf_tree(root, n_videos=6, n_frames=20, size=32):
    """UCF101/jpegs_112/<folder>/frame%06d.jpg, the 50-class split CSV and
    the max-csv with segment boundaries (dataset.py:353-393, :739-782)."""
    base = osp.join(root, "UCF101")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_videos):
        folder = f"v_Pack_g{i:02d}_c01"
        _frames(osp.join(base, "jpegs_112", folder), n_frames - i, size, rng)
        rows.append({"folder_name": folder, "label": f"Class{i % 3}",
                     "split": "train" if i < 4 else "test",
                     "split_index": "[4, 8, 12]"})
    for name, fields in (("ucf50_splits1.csv", ["folder_name", "label",
                                                "split"]),
                         ("ucf50_splits1_max.csv", ["folder_name", "label",
                                                    "split", "split_index"])):
        with open(osp.join(base, name), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)


def _kinetics_tree(root, size=16):
    """Kinetics/{train,val}/<yid_start_end>/ frame dirs of exactly 8 frames,
    a replacement dir and a missing video (dataset.py:96-128)."""
    base = osp.join(root, "Kinetics")
    rng = np.random.default_rng(1)
    for split, csv_split in (("train", "train"), ("val", "validate")):
        rows = []
        for i in range(4):
            yid = f"{split}{i:03d}"
            name = "%s_%06d_%06d" % (yid, i, i + 10)
            where = "replacement" if i == 1 else split
            if i != 3:  # the last video is missing: skipped
                _frames(osp.join(base, where, name), 8, size, rng,
                        "frame_%05d.jpg")
            rows.append({"label": f"act{i % 2}", "youtube_id": yid,
                         "time_start": i, "time_end": i + 10})
        with open(osp.join(base, f"{csv_split}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["label", "youtube_id",
                                              "time_start", "time_end"])
            w.writeheader()
            w.writerows(rows)


def _ssv2_tree(root, size=16):
    """SSv2 annot_{split}.json + class_list.json over frame dirs
    (dataset.py:841-895)."""
    base = osp.join(root, "SSv2")
    rng = np.random.default_rng(2)
    classes = ["Pushing something", "Pulling something"]
    os.makedirs(base)
    with open(osp.join(base, "class_list.json"), "w") as f:
        json.dump(classes, f)
    for split in ("train", "val"):
        annots = []
        for i in range(3):
            vid = f"{split}{i}"
            _frames(osp.join(base, split, vid), 10 + i, size, rng,
                    "frame_%05d.jpg")
            annots.append({"id": vid, "label": classes[i % 2]})
        with open(osp.join(base, f"annot_{split}.json"), "w") as f:
            json.dump(annots, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    _ucf_tree(root)
    _kinetics_tree(root)
    _ssv2_tree(root)
    return root


def _same_store(a, b):
    for f in FILES:
        x, y = np.load(osp.join(a, f)), np.load(osp.join(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    with open(osp.join(a, "meta.json"), "rb") as fa, \
            open(osp.join(b, "meta.json"), "rb") as fb:
        assert fa.read() == fb.read()


CASES = [("miniUCF101", None, 0), ("staticUCF50", None, 0),
         ("staticUCF50", "feature", 1), ("staticUCF50", "mean", 3),
         ("Kinetics400", None, 0), ("SSv2", None, 0), ("staticSSv2", None, 0)]


@pytest.mark.parametrize("dataset,split_mode,split_id", CASES)
def test_packers_write_the_same_bytes(tree, tmp_path, dataset, split_mode,
                                      split_id):
    kw = dict(seed=3, split_mode=split_mode, split_id=split_id)
    ours = packer.pack_dataset(dataset, tree, str(tmp_path / "torch"), **kw)
    ref = jpacker.pack_dataset(dataset, tree, str(tmp_path / "jax"), **kw)
    assert osp.basename(ours) == osp.basename(ref)
    _same_store(ours, ref)

    # each package reads the other's store
    mine, theirs = store.load_packed(ref), jstore.load_packed(ours)
    assert mine.meta == store.load_packed(ours).meta
    for a, b in ((mine.train.clips, theirs.train.clips),
                 (mine.train.labels, theirs.train.labels),
                 (mine.test.frames, theirs.test.frames),
                 (mine.test.offsets, theirs.test.offsets),
                 (mine.test.labels, theirs.test.labels)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mine.train.clips.dtype == np.uint8
    assert len(mine.train) > 0 and len(mine.test) > 0


def test_clip_and_frame_packing_match_jax(tree):
    root = osp.join(tree, "UCF101")
    videos, labels, _ = packer.read_ucf_csv(root, "ucf50_splits1.csv", "train")
    assert (videos, labels) == jpacker.read_ucf_csv(
        root, "ucf50_splits1.csv", "train")[:2]
    meta = DatasetMeta(name="packtest_torch", channel=3, im_size=(32, 32),
                       num_classes=3, mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225), frames=8)
    ours = packer.pack_train_clips(videos, labels, meta,
                                   np.random.default_rng(7), workers=1)
    ref = jpacker.pack_train_clips(videos, labels, meta,
                                   np.random.default_rng(7), workers=1)
    np.testing.assert_array_equal(ours.clips, ref.clips)
    t_ours = packer.pack_test_frames(videos, labels, meta, workers=1)
    t_ref = jpacker.pack_test_frames(videos, labels, meta, workers=1)
    np.testing.assert_array_equal(t_ours.frames, t_ref.frames)
    np.testing.assert_array_equal(t_ours.offsets, t_ref.offsets)


POOLED = """
import sys
import numpy as np
from video_distillation_torch.data import packer
from video_distillation_torch.data.meta import DatasetMeta
root = sys.argv[1]
videos, labels, _ = packer.read_ucf_csv(root, "ucf50_splits1.csv", "train")
videos, labels = videos * 3, labels * 3  # 12 jobs: past the serial cut-off
meta = DatasetMeta(name="pooled", channel=3, im_size=(32, 32), num_classes=3,
                   mean=(0.5,) * 3, std=(0.5,) * 3, frames=8)
a, b = (packer.pack_train_clips(videos, labels, meta,
                                np.random.default_rng(7), workers=w)
        for w in (1, 4))
assert np.array_equal(a.clips, b.clips)
a, b = (packer.pack_test_frames(videos, labels, meta, workers=w)
        for w in (1, 4))
assert np.array_equal(a.frames, b.frames)
assert np.array_equal(a.offsets, b.offsets)
print("pooled ok", a.frames.shape[0])
"""


def test_pooled_packing_matches_serial(tree):
    """The process pool changes no byte and no draw. Run in a process of
    its own: this one has JAX loaded, which must not be forked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", POOLED,
                          osp.join(tree, "UCF101")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "pooled ok" in res.stdout


def test_segment_bounds_match_jax():
    seg = [10, 20, 30]
    for mode in ("mean", "feature"):
        for sid in range(4):
            assert (packer.segment_start_range(mode, sid, 4, 40, seg)
                    == jpacker.segment_start_range(mode, sid, 4, 40, seg))
    with pytest.raises(ValueError, match="unknown split_mode"):
        packer.segment_start_range("median", 0, 4, 40, seg)


@pytest.mark.parametrize("n_total,n_pick", [(10, 5), (3, 5), (100, 8),
                                            (7, 7)])
def test_evenly_spaced(n_total, n_pick):
    got = evenly_spaced(n_total, n_pick)
    assert got == jax_evenly_spaced(n_total, n_pick)
    assert len(got) == n_pick


def test_pack_driver_module_on_the_cpu(tree, tmp_path):
    """``python -m video_distillation_torch.drivers.pack`` packs the UCF
    fixture, and the port's load_data reads the result."""
    out = tmp_path / "packed"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "video_distillation_torch.drivers.pack",
         "--dataset", "miniUCF101", "--data_path", tree, "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"packed -> {out / 'miniUCF101_packed'}" in res.stdout
    data = load_data(DistillConfig(dataset="miniUCF101", data_path=str(out)))
    assert data.train.clips.shape == (4, 16, 112, 112, 3)
    assert data.test.offsets.tolist() == [0, 16, 15 + 16]


def test_load_data_points_at_the_port_pack_driver(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m video_distillation_torch.drivers.pack"):
        load_data(DistillConfig(dataset="miniUCF101",
                                data_path=str(tmp_path)))
