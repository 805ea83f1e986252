"""Distribution Matching: the synthetic set's initialisation.

Port of ``video_distillation_tpu/distill/dm.py:37-55``
(``init_synthetic_raw``), which static learning needs. The rest of DM is
not ported yet (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.store import ClipStore


def init_synthetic_raw(generator: Optional[torch.Generator],
                       store: ClipStore, ipc: int, frames: int,
                       init: str = "real",
                       rng: Optional[np.random.Generator] = None,
                       device="cpu"):
    """(C*ipc, F, H, W, 3) float32 synthetic tensor in normalised space +
    labels [0,0,...,1,1,...] (distill_baseline.py:92-101). 'real' draws
    ``ipc`` distinct clips per class from ``rng`` (the JAX package's draw);
    'noise' draws N(0, 1) from ``generator``."""
    meta = store.meta
    C = meta.num_classes
    shape = (C * ipc, frames, meta.im_size[0], meta.im_size[1], meta.channel)
    labels = torch.as_tensor(np.repeat(np.arange(C), ipc), dtype=torch.int64,
                             device=device)
    if init == "real":
        rng = rng or np.random.default_rng(0)
        idx = store.sample_per_class(rng, ipc).reshape(-1)
        imgs = torch.as_tensor(np.asarray(store.clips[idx]), device=device)
        syn = store.normalize(imgs).reshape(shape)
    else:
        syn = torch.randn(shape, generator=generator, device=device)
    return syn, labels
