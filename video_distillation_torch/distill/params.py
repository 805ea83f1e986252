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
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Entry = Tuple[Tuple[str, ...], str, Tuple[int, ...]]  # (jax path, torch name, jax shape)


def _to_torch_layout(a):
    return a.permute(4, 3, 0, 1, 2) if a.dim() == 5 else a


def _to_jax_layout(a):
    return a.permute(2, 3, 4, 1, 0) if a.dim() == 5 else a


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


def from_jax_params(model, tree_or_flat) -> Dict[str, torch.Tensor]:
    """The port's parameters for ``model`` (a ConvNet3D or a Hallucinator)
    from the JAX package's flax tree or flat vector."""
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


def layout_for(model) -> JaxLayout:
    from ..models.convnet3d import ConvNet3D
    from ..models.hallucinator import Hallucinator

    if isinstance(model, ConvNet3D):
        return JaxLayout.for_convnet3d(model)
    if isinstance(model, Hallucinator):
        return JaxLayout.for_hallucinator(model.weight.shape[1])
    raise NotImplementedError(f"no JAX layout for {type(model).__name__}")
