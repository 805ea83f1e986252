"""Accuracy metrics matching the reference's ``epoch`` bookkeeping
(the reference code's ``utils.py:752-844``): top-1/3/5 and per-class accuracy.

Port of ``video_distillation_tpu/ops/metrics.py``, plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch


def topk_correct(logits, labels, ks=(1, 3, 5),
                 weights: Optional[torch.Tensor] = None):
    """Returns {k: correct_count} summed over the batch (float32);
    ``weights`` (0/1 per sample) masks out padded rows."""
    max_k = min(max(ks), logits.shape[-1])
    pred = logits.topk(max_k, dim=-1).indices
    hits = pred == labels[:, None]  # (B, max_k)
    w = torch.ones(hits.shape[0], device=logits.device) if weights is None \
        else weights.float()
    return {k: (hits[:, :min(k, max_k)].any(dim=1).float() * w).sum()
            for k in ks}


def per_class_correct(logits, labels, num_classes: int,
                      weights: Optional[torch.Tensor] = None):
    """(correct_per_class, count_per_class), each (C,) float32.

    ``weights`` masks out padded rows (0/1 per sample)."""
    ones = torch.ones(logits.shape[0], device=logits.device) \
        if weights is None else weights.float()
    correct = (logits.argmax(dim=-1) == labels).float() * ones
    labels = labels.long()
    corr = torch.zeros(num_classes, device=logits.device).index_add_(0, labels, correct)
    cnt = torch.zeros(num_classes, device=logits.device).index_add_(0, labels, ones)
    return corr, cnt
