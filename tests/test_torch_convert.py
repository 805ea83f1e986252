"""The port's reference-artifact converter against the JAX package's.

``.pt`` files in the reference's layouts (the JAX converter's docstring)
are written with ``torch.save`` from seeded numpy arrays, and both
packages convert each of them, both ways, into files of the same name in
two directories. Every output must hold the same bytes: a ``.npy`` or a
``.pt`` file as a whole, an ``.npz`` member by member (its zip container
stamps the time of writing). Then each round trip gives back the values it
started from, and the CLI converts all four families.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from video_distillation_tpu.drivers import convert as jconv
from video_distillation_torch.distill.mtt import TrajectoryBuffer
from video_distillation_torch.drivers import convert as tconv

NC, F, IM = 3, 8, 64
BUF = dict(model="ConvNet3D", channel=3, num_classes=NC, im_size=(IM, IM),
           frames=F, net_depth=3)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _same_bytes(a, b):
    if a.endswith(".npz"):
        assert _members(a) == _members(b)
    else:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _snapshot(rng):
    """A ConvNet3D snapshot in ``net.parameters()`` order (OIDHW kernels)."""
    shapes = [(64, 3, 3, 7, 7), (64,), (128, 64, 3, 7, 7), (128,),
              (128, 128, 3, 7, 7), (128,), (NC, 128, 1, 1, 1), (NC,)]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.01)
            for s in shapes]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("src")
    paths = {"buffer": str(d / "replay_buffer_0.pt"),
             "static": str(d / "images_5.pt"),
             "static_raw": str(d / "images_raw.pt"),
             "dynamic": str(d / "dynamic_5.pt"),
             "hal": str(d / "hal_5.pt")}
    torch.save([[_snapshot(rng), _snapshot(rng)]], paths["buffer"])
    static = torch.from_numpy(rng.normal(size=(6, 3, 16, 16)).astype(np.float32))
    torch.save({"image": static}, paths["static"])
    torch.save(static, paths["static_raw"])
    torch.save(torch.from_numpy(
        rng.normal(size=(6, F, 1, 16, 16)).astype(np.float32)), paths["dynamic"])
    torch.save({f"{i}.encoder.{k}": torch.from_numpy(
        rng.normal(size=s).astype(np.float32))
        for i in range(2) for k, s in (("weight", (3, 4, 3, 3, 3)),
                                       ("bias", (3,)))}, paths["hal"])
    return paths


def _both(tmp_path, jfn, tfn, src, name, **kw):
    """(JAX output, port output): ``name`` in two directories."""
    out = []
    for tag, fn in (("jax", jfn), ("port", tfn)):
        os.makedirs(tmp_path / tag, exist_ok=True)
        dst = str(tmp_path / tag / name)
        fn(src, dst, **kw)
        out.append(dst)
    return out


@pytest.mark.parametrize("kind,to,name,kw", [
    ("buffer", "npz", "replay_buffer_0.npz", BUF),
    ("static", "npy", "images_5.npy", {}),
    ("static_raw", "npy", "images_raw.npy", {}),
    ("dynamic", "npy", "dynamic_5.npy", {}),
    ("hal", "npz", "hal_5.npz", {}),
])
def test_from_pt_bytes_match_jax(sources, tmp_path, kind, to, name, kw):
    family = kind.split("_")[0]
    j, t = _both(tmp_path, jconv._KINDS[(family, "pt")],
                 tconv._KINDS[(family, "pt")], sources[kind], name, **kw)
    _same_bytes(j, t)


@pytest.mark.parametrize("kind,name,kw", [
    ("buffer", "replay_buffer_0", BUF),
    ("static", "images_5", {}),
    ("dynamic", "dynamic_5", {}),
    ("hal", "hal_5", {}),
])
def test_to_pt_bytes_match_jax_and_round_trip(sources, tmp_path, kind, name,
                                              kw):
    ext = {"buffer": "npz", "hal": "npz"}.get(kind, "npy")
    mid = str(tmp_path / f"{name}.{ext}")
    tconv._KINDS[(kind, "pt")](sources[kind], mid, **kw)
    j, t = _both(tmp_path, jconv._KINDS[(kind, ext)], tconv._KINDS[(kind, ext)],
                 mid, f"{name}.pt", **kw)
    _same_bytes(j, t)
    back = torch.load(t, weights_only=False)
    orig = torch.load(sources[kind], weights_only=False)
    if kind == "buffer":
        for a, b in zip(back[0], orig[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    elif kind == "hal":
        assert back.keys() == orig.keys()
        assert all(torch.equal(back[k], orig[k]) for k in orig)
    elif kind == "static":
        assert torch.equal(back["image"], orig["image"])
    else:
        assert torch.equal(back, orig)


def test_buffer_flat_order_is_the_port_layout(sources, tmp_path):
    """The npz's flat vector maps back through the port's own ConvNet3D
    layout onto the snapshot's tensors."""
    from video_distillation_torch.distill.params import layout_for
    from video_distillation_torch.models.registry import create_model

    dst = str(tmp_path / "buf.npz")
    tconv.buffer_pt_to_npz(sources["buffer"], dst, **BUF)
    traj = TrajectoryBuffer.load(dst).trajectories
    assert traj.shape[:2] == (1, 2)
    net = create_model("ConvNet3D", 3, NC, (IM, IM), F, device="cpu")
    params = layout_for(net).unflatten(torch.from_numpy(traj[0, 1]))
    snap = torch.load(sources["buffer"], weights_only=False)[0][1]
    for name, t in zip([n for n, _ in net.named_parameters()], snap):
        assert torch.equal(params[name], t), name


def test_buffer_of_another_model_is_refused(sources, tmp_path):
    with pytest.raises(ValueError, match="template"):
        tconv.buffer_pt_to_npz(sources["buffer"], str(tmp_path / "b.npz"),
                               **{**BUF, "num_classes": NC + 1})


def test_cli_converts_all_four_families(sources, tmp_path):
    for kind, ext in (("static", "npy"), ("dynamic", "npy"), ("hal", "npz")):
        dst = str(tmp_path / f"{kind}.{ext}")
        tconv.main([kind, sources[kind], dst])
        back = str(tmp_path / f"{kind}_back.pt")
        tconv.main([kind, dst, back])
        assert os.path.exists(back)
    dst = str(tmp_path / "buf.npz")
    tconv.main(["buffer", sources["buffer"], dst, "--num_classes", str(NC),
                "--im_size", str(IM), str(IM), "--frames", str(F)])
    assert TrajectoryBuffer.load(dst).trajectories.shape[:2] == (1, 2)
    with pytest.raises(SystemExit):
        tconv.main(["static", dst, str(tmp_path / "x.pt")])
