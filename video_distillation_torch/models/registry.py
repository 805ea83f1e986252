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


def get_eval_pool(eval_mode: str, model: str, model_eval: Optional[str] = None):
    """Parity with utils.py:973-996 (a copy of the JAX package's). Pools
    that name models not ported yet raise from ``create_model``."""
    model_eval = model_eval or model
    if eval_mode == "M":
        return ["MLP", "ConvNet", "LeNet", "AlexNet", "VGG11", "ResNet18"]
    if eval_mode == "B":
        return ["ConvNetBN", "ConvNetASwishBN", "AlexNetBN", "VGG11BN",
                "ResNet18BN"]
    if eval_mode == "W":
        return ["ConvNetW32", "ConvNetW64", "ConvNetW128", "ConvNetW256"]
    if eval_mode == "D":
        return ["ConvNetD1", "ConvNetD2", "ConvNetD3", "ConvNetD4"]
    if eval_mode == "A":
        return ["ConvNetAS", "ConvNetAR", "ConvNetAL", "ConvNetASwish"]
    if eval_mode == "P":
        return ["ConvNetNP", "ConvNetMP", "ConvNetAP"]
    if eval_mode == "N":
        return ["ConvNetNN", "ConvNetBN", "ConvNetLN", "ConvNetIN",
                "ConvNetGN"]
    if eval_mode == "S":
        return [model[: model.index("BN")]] if "BN" in model else [model]
    if eval_mode == "SS":
        return [model]
    # 'top5' and anything else: evaluate the given model (utils.py:994-995)
    return [model_eval]
