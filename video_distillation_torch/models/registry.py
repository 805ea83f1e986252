"""Model factory (port of ``video_distillation_tpu/models/registry.py``).

Only ConvNet3D is ported; like the reference factory (utils.py:608-609) it
is built with net_norm='none' and net_pooling='maxpooling'.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .convnet3d import ConvNet3D

DEFAULT_WIDTH, DEFAULT_DEPTH, DEFAULT_ACT = 128, 3, "relu"


def create_model(model: str, channel: int, num_classes: int,
                 im_size: Tuple[int, int] = (32, 32), frames: int = 16, *,
                 generator: Optional[torch.Generator] = None, device=None):
    """An initialised torch module for the given model name."""
    if model == "ConvNet3D":
        return ConvNet3D(channel=channel, num_classes=num_classes,
                         net_width=DEFAULT_WIDTH, net_depth=DEFAULT_DEPTH,
                         net_act=DEFAULT_ACT, net_norm="none",
                         net_pooling="maxpooling", frames=frames,
                         im_size=tuple(im_size), generator=generator,
                         device=device)
    raise NotImplementedError(
        f"model {model!r} is not ported yet: only ConvNet3D is; the rest of "
        "the model zoo is ROADMAP A.13")
