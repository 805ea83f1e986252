"""Losses used across the distillation families.

Port of ``video_distillation_tpu/ops/losses.py``. Parity sources:
* cross-entropy — torch ``nn.CrossEntropyLoss`` (mean over batch)
* DC gradient-matching distances — the reference's ``utils.py:634-687``
  (``distance_wb`` layerwise cosine, ``match_loss`` with 'ours'/'mse'/'cos')
* MTT normalized parameter loss — ``distill_baseline.py:255-272``
* FRePo label-margin regulariser — ``FRePo/lib/datadistillation/frepo.py:152-157``

Gradient "pytrees" here are a mapping of named tensors or a sequence of
them, in torch layouts.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits, labels.long())


def soft_cross_entropy(logits, target_probs):
    logp = F.log_softmax(logits, dim=-1)
    return -(target_probs * logp).sum(-1).mean()


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mtt_param_loss(theta_final, theta_start, theta_target):
    """‖θ_K − θ*‖² / ‖θ_0 − θ*‖² over flat param vectors
    (distill_baseline.py:255-272; the /num_params factors cancel)."""
    param_loss = torch.sum((theta_final - theta_target) ** 2)
    param_dist = torch.sum((theta_start - theta_target) ** 2)
    return param_loss / param_dist, param_loss, param_dist


def _rows_out_first(g):
    """Flatten a kernel to (out_features, fan_in) rows. Torch weights are
    already out-first ((out, in, *k) and (out, in)), as distance_wb groups
    them (utils.py:636-642)."""
    return g.reshape(g.shape[0], -1)


def _safe_norm(x, dim):
    # sqrt has an infinite gradient at 0; a grad-row can be exactly zero
    # (dead feature), so smooth the norm instead of special-casing.
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def _distance_wb(gwr, gws):
    """Layerwise cosine distance (utils.py:634-651). 1-D tensors (biases,
    norm scales) contribute 0."""
    if gwr.dim() == 1:
        return gwr.new_zeros(())
    gwr = _rows_out_first(gwr)
    gws = _rows_out_first(gws)
    num = torch.sum(gwr * gws, dim=-1)
    den = _safe_norm(gwr, -1) * _safe_norm(gws, -1) + 1e-6
    return torch.sum(1.0 - num / den)


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def match_loss(gw_syn, gw_real, dis_metric: str = "ours"):
    """DC gradient-matching distance over two gradient trees
    (utils.py:655-687)."""
    syn_leaves = _leaves(gw_syn)
    real_leaves = _leaves(gw_real)
    if dis_metric == "ours":
        return sum(_distance_wb(gr, gs)
                   for gr, gs in zip(real_leaves, syn_leaves))
    if dis_metric in ("mse", "cos"):
        vr = torch.cat([g.reshape(-1) for g in real_leaves])
        vs = torch.cat([g.reshape(-1) for g in syn_leaves])
        if dis_metric == "mse":
            return torch.sum((vs - vr) ** 2)
        return 1.0 - torch.sum(vr * vs) / (
            torch.linalg.norm(vr) * torch.linalg.norm(vs) + 1e-6)
    raise ValueError(f"unknown distance function: {dis_metric}")


def lb_margin_th(logits):
    """FRePo label-margin: -min(top1 - top2, 1/dim) per row
    (frepo.py:152-157)."""
    dim = logits.shape[-1]
    val = torch.topk(logits, k=2, dim=-1).values
    margin = torch.clamp(val[..., 0] - val[..., 1], max=1.0 / dim)
    return -margin


def dm_loss(mean_real, feat_syn):
    """Distribution-matching loss, batched over classes.

    mean_real: (C, D), the real features' class means; feat_syn: (C, ipc,
    D). Equals the reference's per-class python loop sum of squared mean
    differences (distill_baseline.py:344-351) computed as one vectorised
    reduction.
    """
    return torch.sum((mean_real - feat_syn.mean(dim=1)) ** 2)
