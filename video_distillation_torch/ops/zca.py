"""ZCA whitening, FRePo's image preprocessing.

Port of ``video_distillation_tpu/ops/zca.py`` (parity with the reference's
``FRePo/lib/dataset/ops.py``: the streaming mean and covariance over the
train set, :83-139; the regularised eigen-whitening transform and its
inverse, :175-226; the forward and reverse preprocess ops, :229-284).
``fit_zca`` is the JAX module's numpy, copied as it is: fp64 accumulation
and eigendecomposition on the host, stored in fp32. ``apply_zca`` and
``invert_zca`` are one matmul each, on the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ZCAState:
    mean: np.ndarray        # (D,)
    whiten: np.ndarray      # (D, D)
    dewhiten: np.ndarray    # (D, D)
    shape: Tuple[int, ...]  # per-sample shape


def fit_zca(x: np.ndarray, reg: float = 0.1,
            batch: int = 4096) -> ZCAState:
    """Fit on (N, ...) float images (already scaled to [0,1] or
    normalised); streaming accumulation keeps memory flat."""
    n = x.shape[0]
    d = int(np.prod(x.shape[1:]))
    mean = np.zeros(d, np.float64)
    for i in range(0, n, batch):
        mean += x[i:i + batch].reshape(-1, d).sum(axis=0)
    mean /= n
    cov = np.zeros((d, d), np.float64)
    for i in range(0, n, batch):
        xb = x[i:i + batch].reshape(-1, d) - mean
        cov += xb.T @ xb
    cov /= n
    eigval, eigvec = np.linalg.eigh(cov)
    eigval = np.maximum(eigval, 0.0)
    # regularisation as in ops.py: reg * average eigenvalue
    lam = reg * eigval.mean()
    inv_sqrt = 1.0 / np.sqrt(eigval + lam)
    sqrt = np.sqrt(eigval + lam)
    whiten = (eigvec * inv_sqrt) @ eigvec.T
    dewhiten = (eigvec * sqrt) @ eigvec.T
    return ZCAState(mean=mean.astype(np.float32),
                    whiten=whiten.astype(np.float32),
                    dewhiten=dewhiten.astype(np.float32),
                    shape=tuple(x.shape[1:]))


def _on(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def apply_zca(state: ZCAState, x: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> whitened (N, ...), ``(x - mean) @ whiten.T``."""
    flat = x.reshape(x.shape[0], -1) - _on(state.mean, x)
    out = flat @ _on(state.whiten, x).T
    return out.reshape((x.shape[0],) + state.shape)


def invert_zca(state: ZCAState, x: torch.Tensor) -> torch.Tensor:
    """The inverse: ``x @ dewhiten.T + mean``."""
    flat = x.reshape(x.shape[0], -1)
    out = flat @ _on(state.dewhiten, x).T + _on(state.mean, x)
    return out.reshape((x.shape[0],) + state.shape)
