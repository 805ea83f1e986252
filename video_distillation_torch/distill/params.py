"""Parameter bridge between the port's torch modules and the JAX package's
flat parameter vector.

MTT works on one flat fp32 vector θ, and the expert buffers
(``replay_buffer_{n}.npz``) store it. Both packages must read the same
files, so θ is the JAX package's: ``ravel_pytree`` of the flax parameter
tree (``video_distillation_tpu/distill/mtt.py:88-100``). That order is
written here as code, with no flax:

* leaves in sorted-key order of the nested tree, so within a layer
  ``bias`` comes before ``kernel``; for ConvNet3D at 50 classes::

    TemporalIm2ColConv_0/bias (64,)   /kernel (3,7,7,3,64)
    TemporalIm2ColConv_1/bias (128,)  /kernel (3,7,7,64,128)
    TemporalIm2ColConv_2/bias (128,)  /kernel (3,7,7,128,128)
    TorchConv_0/Conv_0/bias (50,)     /kernel (1,1,1,128,50)

  P = 3,647,666;
* conv kernels DHWIO, row-major. Torch's Conv3d weight is OIDHW, so a
  kernel maps over with ``permute(4, 3, 0, 1, 2)`` and back with
  ``permute(2, 3, 4, 1, 0)`` (the transposes of
  ``video_distillation_tpu/drivers/convert.py:42-49``).

The Hallucinator's flax tree is ``{'kernel': (3,3,3,cin,3), 'bias': (3,)}``.
``frepo_carry_from_jax`` converts a JAX FRePo trainer's state (the S2D
tensors, the synthetic optimizer's moments and each pool net with its Adam
moments) so that both packages can start from one point.

The 2-D ConvNet's (static learning; at 50 classes and 112x112 with the
default instancenorm, P = 1,553,970)::

    GroupNorm_{0,1,2}/bias, /scale (128,)       (LayerNorm_d with layernorm)
    TorchConv_0/Conv_0/bias (128,)   /kernel (3,3,3,128)
    TorchConv_{1,2}/Conv_0/bias (128,) /kernel (3,3,128,128)
    TorchDense_0/Dense_0/bias (50,)  /kernel (25088, 50)

with 2-D conv kernels HWIO (torch: OIHW), the dense kernel (in, out)
(torch: (out, in)) and flax's norm ``scale`` the torch ``weight``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Entry = Tuple[Tuple[str, ...], str, Tuple[int, ...]]  # (jax path, torch name, jax shape)


# JAX layout -> torch layout by rank: DHWIO -> OIDHW, HWIO -> OIHW,
# (in, out) -> (out, in); and back
_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_TO_JAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _dense_entries(top, name, linear) -> List[Entry]:
    """A TorchDense's flax leaves (``Dense_0/bias``, ``/kernel`` (in, out))
    for a torch Linear (weight (out, in))."""
    o, i = linear.weight.shape
    return [(top + ("Dense_0", "bias"), f"{name}.bias", (o,)),
            (top + ("Dense_0", "kernel"), f"{name}.weight", (i, o))]


def _to_torch_layout(a):
    return a.permute(*_TO_TORCH[a.dim()]) if a.dim() in _TO_TORCH else a


def _to_jax_layout(a):
    return a.permute(*_TO_JAX[a.dim()]) if a.dim() in _TO_JAX else a


class JaxLayout:
    """The JAX flat-vector layout of one module's parameters."""

    def __init__(self, entries: List[Entry]):
        self.entries = sorted(entries, key=lambda e: e[0])
        self.offsets, off = [], 0
        for _, _, shape in self.entries:
            self.offsets.append(off)
            off += math.prod(shape)
        self.size = off

    @classmethod
    def for_convnet3d(cls, model) -> "JaxLayout":
        entries = []
        for d, conv in enumerate(model.convs):
            o, i, kd, kh, kw = conv.weight.shape
            top = f"TemporalIm2ColConv_{d}"
            entries.append(((top, "bias"), f"convs.{d}.bias", (o,)))
            entries.append(((top, "kernel"), f"convs.{d}.weight", (kd, kh, kw, i, o)))
        o, i = model.head.weight.shape[:2]
        entries.append((("TorchConv_0", "Conv_0", "bias"), "head.bias", (o,)))
        entries.append((("TorchConv_0", "Conv_0", "kernel"), "head.weight",
                        (1, 1, 1, i, o)))
        return cls(entries)

    @classmethod
    def for_convnet2d(cls, model) -> "JaxLayout":
        entries = []
        norm = "LayerNorm" if model.net_norm == "layernorm" else "GroupNorm"
        for d, conv in enumerate(model.convs):
            o, i, kh, kw = conv.weight.shape
            top = (f"TorchConv_{d}", "Conv_0")
            entries.append((top + ("bias",), f"convs.{d}.bias", (o,)))
            entries.append((top + ("kernel",), f"convs.{d}.weight", (kh, kw, i, o)))
            if model.net_norm != "none":
                entries.append(((f"{norm}_{d}", "bias"), f"norms.{d}.bias", (o,)))
                entries.append(((f"{norm}_{d}", "scale"), f"norms.{d}.weight", (o,)))
        if model.head is not None:
            entries += _dense_entries(("TorchDense_0",), "head", model.head)
        return cls(entries)

    @classmethod
    def for_video_convnet(cls, model) -> "JaxLayout":
        """The flax tree of ``VideoConvNet``: the per-frame backbone under
        ``ConvNet2D_0``, the head's TorchDense, and the temporal head's
        parameters (``_Recurrent_0``'s, or MLP's at the top level)."""
        entries = [(("ConvNet2D_0",) + path, f"backbone.{name}", shape)
                   for path, name, shape in cls.for_convnet2d(model.backbone).entries]
        entries += _dense_entries(("TorchDense_0",), "head", model.head)
        if model.head_kind == "mlp":
            d, f, _ = model.temporal_weight.shape
            entries.append((("temporal_bias",), "temporal_bias", (d, 1)))
            entries.append((("temporal_weight",), "temporal_weight", (d, f, 1)))
        elif model.head_kind != "mean":
            rnn = model.recurrent
            gh, d = rnn.weight_ih.shape
            top = ("_Recurrent_0",)
            entries.append((top + ("b_hh",), "recurrent.bias_hh", (gh,)))
            entries.append((top + ("b_ih",), "recurrent.bias_ih", (gh,)))
            entries.append((top + ("w_hh",), "recurrent.weight_hh", (gh // rnn.gates, gh)))
            entries.append((top + ("w_ih",), "recurrent.weight_ih", (d, gh)))
        return cls(entries)

    @classmethod
    def for_hallucinator(cls, cin: int = 4) -> "JaxLayout":
        return cls([(("bias",), "bias", (3,)),
                    (("kernel",), "weight", (3, 3, 3, cin, 3))])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """torch-layout views into ``flat`` (differentiable, no copy)."""
        if flat.numel() != self.size:
            raise ValueError(f"flat vector has {flat.numel()} values, "
                             f"layout needs {self.size}")
        return {name: _to_torch_layout(flat[off:off + math.prod(shape)].view(shape))
                for (_, name, shape), off in zip(self.entries, self.offsets)}

    def flatten(self, params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([_to_jax_layout(params[name]).reshape(-1)
                          for _, name, _ in self.entries])

    def from_jax(self, tree_or_flat, device=None) -> Dict[str, torch.Tensor]:
        """torch-layout tensors from a flax tree (nested dicts of arrays) or
        a flat numpy vector in the JAX order."""
        if isinstance(tree_or_flat, Mapping):
            leaves = []
            for path, _, shape in self.entries:
                node = tree_or_flat
                for k in path:
                    node = node[k]
                leaf = np.asarray(node, np.float32)
                if leaf.shape != shape:
                    raise ValueError(f"{'/'.join(path)}: shape {leaf.shape} != {shape}")
                leaves.append(leaf.reshape(-1))
            flat = np.concatenate(leaves)
        else:
            flat = np.array(tree_or_flat, np.float32).reshape(-1)
        t = torch.as_tensor(flat, device=device)
        return {k: v.contiguous() for k, v in self.unflatten(t).items()}


def to_jax_tree(layout: JaxLayout, params: Mapping[str, torch.Tensor]) -> dict:
    """The flax tree (nested dicts of fp32 numpy arrays in the JAX layouts)
    of torch-layout parameters, e.g. a hallucinator's
    ``{'kernel': (3,3,3,4,3) DHWIO, 'bias': (3,)}``."""
    tree: dict = {}
    for path, name, shape in layout.entries:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = _to_jax_layout(params[name].detach().float().cpu())
        node[path[-1]] = leaf.contiguous().numpy().reshape(shape)
    return tree


def hal_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """A hallucinator's ``{'weight', 'bias'}`` as the JAX package's
    ``{'kernel', 'bias'}`` (what its ``hal_{it}.npz`` artifacts hold)."""
    return to_jax_tree(JaxLayout.for_hallucinator(params["weight"].shape[1]),
                       params)


def from_jax_params(model, tree_or_flat) -> Dict[str, torch.Tensor]:
    """The port's parameters for ``model`` (a ConvNet3D, a ConvNet2D or a
    Hallucinator) from the JAX package's flax tree or flat vector."""
    layout = layout_for(model)
    device = next(model.parameters()).device
    return layout.from_jax(tree_or_flat, device=device)


def to_jax_flat(model_or_params, model=None) -> np.ndarray:
    """The JAX package's flat vector for a module's parameters (or for a
    dict of them, given the module they belong to)."""
    if model is None:
        model = model_or_params
        params = dict(model.named_parameters())
    else:
        params = model_or_params
    params = {k: v.detach().float().cpu() for k, v in params.items()}
    return layout_for(model).flatten(params).numpy()


def _hal_from_jax(tree, device=None) -> Dict[str, torch.Tensor]:
    cin = np.asarray(tree["kernel"]).shape[3]
    return JaxLayout.for_hallucinator(cin).from_jax(tree, device=device)


def _frepo_tree_from_jax(tree: Mapping, device=None) -> dict:
    """A FRePo state-shaped tree (``dynamic``, ``hals``, ``y_syn`` or
    ``x_proto``) of numpy leaves in the JAX layouts -> torch tensors."""
    out = {}
    for k, v in tree.items():
        if k == "hals":
            out[k] = [_hal_from_jax(h, device) for h in v]
        else:
            out[k] = torch.as_tensor(np.array(v, np.float32), device=device)
    return out


def frepo_carry_from_jax(model, state: Mapping, pool=(), opt=None,
                         device=None) -> dict:
    """The port's FRePo trainer state (``FRePoTrainer.load_state_dict``)
    from the JAX trainer's, as numpy:

    * ``state``: ``{'dynamic', 'hals': [{'kernel', 'bias'}], 'y_syn'}`` (or
      ``{'x_proto', 'y_syn'}``);
    * ``pool``: each JAX pool element as ``{'params', 'mu', 'nu'}`` (flax
      trees of the net ``model`` is) and ``'count'`` (optax's) and
      ``'step'`` (the element's);
    * ``opt``: ``{'count', 'mu', 'nu'}`` with ``state``'s structure, or
      None for a fresh optimizer (zero moments, count 0)."""
    st = _frepo_tree_from_jax(state, device)
    if opt is None:
        def zeros():
            return {k: ([{n: torch.zeros_like(t) for n, t in h.items()}
                         for h in v] if k == "hals" else torch.zeros_like(v))
                    for k, v in st.items()}
        opt_t = {"count": 0, "m": zeros(), "v": zeros()}
    else:
        opt_t = {"count": int(opt["count"]),
                 "m": _frepo_tree_from_jax(opt["mu"], device),
                 "v": _frepo_tree_from_jax(opt["nu"], device)}
    layout = layout_for(model)

    def flat(tree):
        return layout.flatten(layout.from_jax(tree, device=device))

    elements = [{"params": flat(el["params"]), "m": flat(el["mu"]),
                 "v": flat(el["nu"]), "count": int(el["count"]),
                 "step": int(el["step"])} for el in pool]
    return {"state": st, "opt": opt_t, "pool": elements}


def layout_for(model) -> JaxLayout:
    from ..models.convnet2d import ConvNet2D
    from ..models.convnet3d import ConvNet3D
    from ..models.hallucinator import Hallucinator
    from ..models.video_nets import VideoConvNet

    if isinstance(model, ConvNet3D):
        return JaxLayout.for_convnet3d(model)
    if isinstance(model, ConvNet2D):
        return JaxLayout.for_convnet2d(model)
    if isinstance(model, VideoConvNet):
        return JaxLayout.for_video_convnet(model)
    if isinstance(model, Hallucinator):
        return JaxLayout.for_hallucinator(model.weight.shape[1])
    raise NotImplementedError(f"no JAX layout for {type(model).__name__}")
