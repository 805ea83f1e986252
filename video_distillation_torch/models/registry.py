"""Model factory (port of ``video_distillation_tpu/models/registry.py``).

Ported: ConvNet3D, built as the reference factory builds it (utils.py:
608-609) with net_norm='none' and net_pooling='maxpooling'; the video
models ``VideoConvNet{Mean,MLP,LSTM,RNN,GRU}`` (per-frame ConvNet with a
temporal head); and the 2-D ConvNet with its depth, width, activation,
norm and pooling variants (``ConvNetD*``, ``ConvNetW*``,
``ConvNetAS/AR/AL/ASwish``, ``ConvNetNN/IN/GN/LN``, ``ConvNetNP/MP/AP``).
The image models (BatchNorm variants, the classic nets, FRePo's) raise:
they come with the image datasets (ROADMAP A.15b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .convnet2d import ConvNet2D
from .convnet3d import ConvNet3D
from .video_nets import VideoConvNet

DEFAULT_WIDTH, DEFAULT_DEPTH = 128, 3
DEFAULT_ACT, DEFAULT_NORM, DEFAULT_POOLING = "relu", "instancenorm", "avgpooling"

# ConvNet variants by name suffix (registry.py:67-98)
_CONVNET_VARIANTS = {
    "": {}, "AS": {"net_act": "sigmoid"}, "AR": {"net_act": "relu"},
    "AL": {"net_act": "leakyrelu"}, "ASwish": {"net_act": "swish"},
    "NN": {"net_norm": "none"}, "LN": {"net_norm": "layernorm"},
    "IN": {"net_norm": "instancenorm"}, "GN": {"net_norm": "groupnorm"},
    "NP": {"net_pooling": "none"}, "MP": {"net_pooling": "maxpooling"},
    "AP": {"net_pooling": "avgpooling"}}


def _convnet_kwargs(model: str) -> Optional[dict]:
    """ConvNet2D's overrides for a ported ConvNet variant name, else None."""
    if not model.startswith("ConvNet"):
        return None
    tail = model[len("ConvNet"):]
    if tail in _CONVNET_VARIANTS:
        return _CONVNET_VARIANTS[tail]
    if tail[:1] in ("D", "W") and tail[1:].isdigit():
        return {"net_depth" if tail[0] == "D" else "net_width": int(tail[1:])}
    return None


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
    if model.startswith("VideoConvNet"):
        head = model[len("VideoConvNet"):].lower()
        if head not in ("mean", "mlp", "lstm", "rnn", "gru"):
            raise ValueError(f"unknown model: {model}")
        return VideoConvNet(channel=channel, num_classes=num_classes,
                            net_width=DEFAULT_WIDTH, net_depth=DEFAULT_DEPTH,
                            net_act=DEFAULT_ACT, net_norm=DEFAULT_NORM,
                            net_pooling=DEFAULT_POOLING, im_size=tuple(im_size),
                            frames=frames, head=head, generator=generator,
                            device=device)
    kw = _convnet_kwargs(model)
    if kw is not None:
        base = dict(channel=channel, num_classes=num_classes,
                    net_width=DEFAULT_WIDTH, net_depth=DEFAULT_DEPTH,
                    net_act=DEFAULT_ACT, net_norm=DEFAULT_NORM,
                    net_pooling=DEFAULT_POOLING, im_size=tuple(im_size))
        return ConvNet2D(**{**base, **kw}, generator=generator, device=device)
    raise NotImplementedError(
        f"model {model!r} is not ported yet: the image models (the "
        "BatchNorm ConvNets, MLP, LeNet, AlexNet, VGG, ResNet, FRePo's "
        "nets) come with the image datasets (ROADMAP A.15b)")


def is_video_model(model: str) -> bool:
    """Models that consume (B, F, H, W, C) clips."""
    return model == "ConvNet3D" or model.startswith("VideoConvNet")


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
