"""Convert the reference's torch ``.pt`` artifacts <-> the ``.npy`` / ``.npz``
files the port (and the JAX package) read and write.

Port of ``video_distillation_tpu/drivers/convert.py``, with its CLI::

    python -m video_distillation_torch.drivers.convert \
        {buffer,static,dynamic,hal} src dst [--model ... --num_classes ...]

The direction follows the source's extension. The four families:

* **replay buffers**: ``replay_buffer_{n}.pt``, a list of expert
  trajectories, each a list of per-epoch snapshots, each a list of
  per-layer tensors in ``net.parameters()`` order (the reference's
  ``buffer.py:98-104``) <-> the dense ``(num_experts, E+1, P)`` float32
  npz of ``distill.mtt.TrajectoryBuffer``, P in the JAX flat order
  (``distill.params.JaxLayout`` in place of the JAX ``ravel_pytree``);
* **static memories**: ``images_{it}.pt``, a raw NCHW tensor or the
  ``{"image": tensor}`` dict the reference loads (``distill_s2d_ms.py:
  96-99``) <-> NHWC ``.npy``;
* **dynamic memories**: ``dynamic_{it}.pt`` ``(N, F, 1, H, W)`` <->
  ``(N, F, H, W, 1)`` ``.npy``;
* **hallucinator weights**: ``hal_{it}.pt``, an ``nn.ModuleList``
  state_dict (``{i}.encoder.weight`` (O, I, kt, kh, kw), ``{i}.encoder.
  bias``) <-> the ``save_pytree_artifact`` npz the S2D driver writes
  (``hal_{it}.npz``, keys ``[i]['kernel']`` (kt, kh, kw, I, O) and
  ``[i]['bias']``).

Each output holds the bytes the JAX package's converter writes from the
same input file (an npz's members; the zip container stamps its time).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..distill.mtt import TrajectoryBuffer
from ..distill.params import layout_for, to_jax_tree
from ..models.registry import create_model
from ..utils.checkpoint import save_pytree_artifact


# ---------------------------------------------------------------------------
# kernel layout
# ---------------------------------------------------------------------------

def torch_to_flax_conv(w: np.ndarray) -> np.ndarray:
    """(O, I, kt, kh, kw) -> (kt, kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def flax_to_torch_conv(k: np.ndarray) -> np.ndarray:
    """(kt, kh, kw, I, O) -> (O, I, kt, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))


def _load(src: str):
    return torch.load(src, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------------------
# replay buffers
# ---------------------------------------------------------------------------

def _convnet3d_names(net_depth: int):
    """The flax tree path of each ``parameters()`` slot of the norm-free
    ConvNet3D (the only video model the reference's buffer.py trains;
    utils.py:608-609): the ``features`` convs, then ``logit``
    (networks.py:727-736)."""
    names = [("TemporalIm2ColConv_%d" % i,) for i in range(net_depth)]
    names.append(("TorchConv_0", "Conv_0"))
    return names


def snapshot_to_tree(snapshot, net_depth: int = 3):
    """One per-layer-tensor snapshot -> the named flax tree."""
    names = _convnet3d_names(net_depth)
    if len(snapshot) != 2 * len(names):
        raise ValueError(
            f"snapshot has {len(snapshot)} tensors; expected "
            f"{2 * len(names)} for a norm-free depth-{net_depth} ConvNet3D")
    tree = {}
    for i, path in enumerate(names):
        w = np.asarray(snapshot[2 * i], np.float32)
        b = np.asarray(snapshot[2 * i + 1], np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {"kernel": torch_to_flax_conv(w), "bias": b}
    return tree


def tree_to_snapshot(tree, net_depth: int = 3):
    """Inverse of :func:`snapshot_to_tree` (torch ``parameters()`` order)."""
    out = []
    for path in _convnet3d_names(net_depth):
        node = tree
        for p in path:
            node = node[p]
        out.append(flax_to_torch_conv(np.asarray(node["kernel"])))
        out.append(np.asarray(node["bias"]))
    return out


def _template_layout(model, channel, num_classes, im_size, frames):
    net = create_model(model, channel, num_classes, tuple(im_size), frames,
                       device="cpu")
    return layout_for(net)


def buffer_pt_to_npz(src: str, dst: str, model: str = "ConvNet3D",
                     channel: int = 3, num_classes: int = 50,
                     im_size=(112, 112), frames: int = 16,
                     net_depth: int = 3):
    """replay_buffer_{n}.pt -> TrajectoryBuffer npz. Each snapshot is
    flattened through the named tree in the layout's order, so the flat
    order is the JAX ``flat_param_template``'s whatever the order of
    ``parameters()``."""
    layout = _template_layout(model, channel, num_classes, im_size, frames)

    def to_flat(snap):
        tree = snapshot_to_tree([t.detach().cpu().numpy() for t in snap],
                                net_depth)
        try:
            leaves = []
            for path, _, shape in layout.entries:
                node = tree
                for k in path:
                    node = node[k]
                if node.shape != shape:
                    raise ValueError(f"{'/'.join(path)}: {node.shape} != {shape}")
                leaves.append(node.reshape(-1))
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"snapshot does not fit the {model} template ({e}); check "
                "the model/channel/num_classes/im_size/frames flags") from e
        return np.concatenate(leaves)

    trajs = np.stack([np.stack([to_flat(s) for s in traj])
                      for traj in _load(src)])
    TrajectoryBuffer(trajs).save(dst)
    return trajs.shape


def buffer_npz_to_pt(src: str, dst: str, model: str = "ConvNet3D",
                     channel: int = 3, num_classes: int = 50,
                     im_size=(112, 112), frames: int = 16,
                     net_depth: int = 3):
    """TrajectoryBuffer npz -> the reference's list-of-lists .pt."""
    layout = _template_layout(model, channel, num_classes, im_size, frames)
    buf = TrajectoryBuffer.load(src)
    out = []
    for traj in buf.trajectories:
        snaps = []
        for flat in traj:
            tree = to_jax_tree(layout, layout.from_jax(flat))
            snaps.append([torch.from_numpy(np.array(t, np.float32))
                          for t in tree_to_snapshot(tree, net_depth)])
        out.append(snaps)
    torch.save(out, dst)
    return buf.trajectories.shape


# ---------------------------------------------------------------------------
# static / dynamic memories
# ---------------------------------------------------------------------------

def static_pt_to_npy(src: str, dst: str):
    """images_{it}.pt (raw NCHW tensor or {"image": tensor} dict) ->
    NHWC .npy."""
    raw = _load(src)
    if isinstance(raw, dict):
        raw = raw["image"]
    arr = np.asarray(raw.detach().cpu().numpy(), np.float32)
    if arr.ndim != 4:
        raise ValueError(f"expected a 4-D static tensor, got {arr.shape}")
    if arr.shape[1] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (0, 2, 3, 1))
    np.save(dst, np.ascontiguousarray(arr))
    return arr.shape


def static_npy_to_pt(src: str, dst: str):
    """NHWC .npy -> {"image": NCHW tensor}, what the reference's
    ``--path_static`` loads (distill_s2d_ms.py:97)."""
    arr = np.load(src)
    if arr.shape[-1] == 3 and arr.shape[1] != 3:
        arr = np.transpose(arr, (0, 3, 1, 2))
    torch.save({"image": torch.from_numpy(
        np.ascontiguousarray(arr.astype(np.float32)))}, dst)
    return arr.shape


def dynamic_pt_to_npy(src: str, dst: str):
    """dynamic_{it}.pt (N, F, 1, H, W) -> (N, F, H, W, 1) .npy."""
    arr = np.asarray(_load(src).detach().cpu().numpy(), np.float32)
    if arr.ndim != 5 or arr.shape[2] != 1:
        raise ValueError(
            f"expected a (N, F, 1, H, W) dynamic tensor, got {arr.shape}")
    arr = np.transpose(arr, (0, 1, 3, 4, 2))
    np.save(dst, np.ascontiguousarray(arr))
    return arr.shape


def dynamic_npy_to_pt(src: str, dst: str):
    """(N, F, H, W, 1) .npy -> (N, F, 1, H, W) .pt."""
    arr = np.load(src)
    if arr.ndim != 5 or arr.shape[-1] != 1:
        raise ValueError(
            f"expected a (N, F, H, W, 1) dynamic array, got {arr.shape}")
    arr = np.transpose(arr, (0, 1, 4, 2, 3))
    torch.save(torch.from_numpy(
        np.ascontiguousarray(arr.astype(np.float32))), dst)
    return arr.shape


# ---------------------------------------------------------------------------
# hallucinator weights
# ---------------------------------------------------------------------------

def hal_pt_to_npz(src: str, dst: str):
    """ModuleList state_dict ({i}.encoder.weight/bias) -> the list of
    {kernel, bias} npz (``save_pytree_artifact``)."""
    sd = _load(src)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    n = 1 + max(int(k.split(".")[0]) for k in sd)
    hals = []
    for i in range(n):
        w = np.asarray(sd[f"{i}.encoder.weight"].detach().cpu().numpy(),
                       np.float32)
        b = np.asarray(sd[f"{i}.encoder.bias"].detach().cpu().numpy(),
                       np.float32)
        hals.append({"kernel": torch_to_flax_conv(w), "bias": b})
    d, name = os.path.split(dst)
    save_pytree_artifact(d or ".", name[:-4] if name.endswith(".npz")
                         else name, hals)
    return n


def hal_npz_to_pt(src: str, dst: str):
    """The hal_{it}.npz artifact -> the reference's ModuleList state_dict."""
    with np.load(src) as z:
        # keys look like "[0]['kernel']" (keystr of a list-of-dicts tree)
        n = 1 + max(int(k.split("]")[0][1:]) for k in z.files)
        sd = {}
        for i in range(n):
            sd[f"{i}.encoder.weight"] = torch.from_numpy(
                flax_to_torch_conv(np.asarray(z[f"[{i}]['kernel']"],
                                              np.float32)))
            sd[f"{i}.encoder.bias"] = torch.from_numpy(
                np.asarray(z[f"[{i}]['bias']"], np.float32))
    torch.save(sd, dst)
    return n


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

_KINDS = {
    ("buffer", "pt"): buffer_pt_to_npz,
    ("buffer", "npz"): buffer_npz_to_pt,
    ("static", "pt"): static_pt_to_npy,
    ("static", "npy"): static_npy_to_pt,
    ("dynamic", "pt"): dynamic_pt_to_npy,
    ("dynamic", "npy"): dynamic_npy_to_pt,
    ("hal", "pt"): hal_pt_to_npz,
    ("hal", "npz"): hal_npz_to_pt,
}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert reference .pt artifacts <-> npy/npz "
                    "(direction inferred from the source extension)")
    p.add_argument("kind", choices=("buffer", "static", "dynamic", "hal"))
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--model", default="ConvNet3D")
    p.add_argument("--channel", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=50)
    p.add_argument("--im_size", type=int, nargs=2, default=(112, 112))
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--net_depth", type=int, default=3)
    a = p.parse_args(argv)
    ext = a.src.rsplit(".", 1)[-1].lower()
    fn = _KINDS.get((a.kind, ext))
    if fn is None:
        p.error(f"no {a.kind} conversion from .{ext}")
    if a.kind == "buffer":
        shape = fn(a.src, a.dst, a.model, a.channel, a.num_classes,
                   tuple(a.im_size), a.frames, a.net_depth)
    else:
        shape = fn(a.src, a.dst)
    print(f"converted {a.kind}: {a.src} -> {a.dst} ({shape})")


if __name__ == "__main__":
    sys.exit(main())
