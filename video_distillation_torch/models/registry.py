"""Model factory (port of ``video_distillation_tpu/models/registry.py``).

Every name of the JAX ``create_model``: ConvNet3D, built as the reference
factory builds it (utils.py:608-609) with net_norm='none' and
net_pooling='maxpooling'; the video models
``VideoConvNet{Mean,MLP,LSTM,RNN,GRU}`` (per-frame ConvNet with a temporal
head); the 2-D ConvNet with its depth, width, activation, norm and pooling
variants (``ConvNetD*``, ``ConvNetW*``, ``ConvNetAS/AR/AL/ASwish``,
``ConvNetNN/IN/GN/LN/BN``, ``ConvNetASwishBN``, ``ConvNetNP/MP/AP``,
``DC_ConvNet``/``dcconv``); the classic nets (MLP, LeNet, AlexNet(BN),
VGG11/13/16/19(BN), ResNet18(BN)(_AP)); FRePo's ``KIP_ConvNet``/``kipconv``
and ``Conv``/``conv``.

The BatchNorm nets come with their running statistics (module buffers).
No path of the JAX package runs them: every ``apply`` there hands flax the
parameters alone, and flax raises for the missing ``batch_stats`` (ROADMAP
C.17). ``path_model`` is ``create_model`` for the paths (evaluation, DM,
MTT, DC, coresets, FRePo, experts), and raises for them likewise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .classic import CFG_VGG, MLP, VGG, AlexNet, LeNet, ResNet
from .convnet2d import ConvNet2D
from .convnet3d import ConvNet3D
from .frepo_nets import FRePoConv, KIPConvNet
from .layers import BatchNorm
from .video_nets import VideoConvNet

DEFAULT_WIDTH, DEFAULT_DEPTH = 128, 3
DEFAULT_ACT, DEFAULT_NORM, DEFAULT_POOLING = "relu", "instancenorm", "avgpooling"

# ConvNet variants by name suffix (registry.py:67-98)
_CONVNET_VARIANTS = {
    "": {}, "AS": {"net_act": "sigmoid"}, "AR": {"net_act": "relu"},
    "AL": {"net_act": "leakyrelu"}, "ASwish": {"net_act": "swish"},
    "ASwishBN": {"net_act": "swish", "net_norm": "batchnorm"},
    "NN": {"net_norm": "none"}, "LN": {"net_norm": "layernorm"},
    "BN": {"net_norm": "batchnorm"},
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
    if model in ("DC_ConvNet", "dcconv"):
        # DC_ConvNet == ConvNet2D with identity norm / avg pool
        model = "ConvNetNN"
    kw = _convnet_kwargs(model)
    if kw is not None:
        base = dict(channel=channel, num_classes=num_classes,
                    net_width=DEFAULT_WIDTH, net_depth=DEFAULT_DEPTH,
                    net_act=DEFAULT_ACT, net_norm=DEFAULT_NORM,
                    net_pooling=DEFAULT_POOLING, im_size=tuple(im_size))
        return ConvNet2D(**{**base, **kw}, generator=generator, device=device)
    common = dict(channel=channel, num_classes=num_classes,
                  im_size=tuple(im_size), generator=generator, device=device)
    if model == "MLP":
        return MLP(**common)
    if model == "LeNet":
        return LeNet(**common)
    if model in ("AlexNet", "AlexNetBN"):
        return AlexNet(use_bn=model.endswith("BN"), **common)
    if model.removesuffix("BN") in CFG_VGG:
        return VGG(model.removesuffix("BN"),
                   norm="batchnorm" if model.endswith("BN") else "instancenorm",
                   **common)
    if model in ("ResNet18", "ResNet18BN", "ResNet18BN_AP", "ResNet18_AP"):
        return ResNet(norm="batchnorm" if "BN" in model else "instancenorm",
                      avg_pool_down=model.endswith("_AP"), **common)
    # FRePo's evaluation-pool nets (FRePo/lib/models/utils.py arch names)
    if model in ("KIP_ConvNet", "kipconv"):
        return KIPConvNet(width=DEFAULT_WIDTH, depth=DEFAULT_DEPTH, **common)
    if model in ("Conv", "conv"):
        return FRePoConv(width=DEFAULT_WIDTH, depth=DEFAULT_DEPTH, **common)
    raise ValueError(f"unknown model: {model}")


def has_batch_stats(model) -> bool:
    """Whether a torch module holds BatchNorm running statistics."""
    return any(isinstance(m, BatchNorm) for m in model.modules())


def path_model(model: str, channel: int, num_classes: int,
               im_size: Tuple[int, int] = (32, 32), frames: int = 16, *,
               generator: Optional[torch.Generator] = None, device=None):
    """``create_model`` for the distillation and evaluation paths, which
    carry a net as its flat parameters alone, as the JAX package's do
    (``{"params": p}`` in every ``apply``). A BatchNorm net raises there:
    its ``batch_stats`` are missing, and flax raises
    ``ScopeCollectionNotFound`` for them in train and eval mode alike
    (ROADMAP C.17)."""
    net = create_model(model, channel, num_classes, im_size, frames,
                       generator=generator, device=device)
    if has_batch_stats(net):
        raise ValueError(
            f"{model} is a BatchNorm net: no path of the JAX package runs "
            "it (each applies the parameters without the batch_stats "
            "collection, and flax raises ScopeCollectionNotFound), and the "
            "port fails with it (ROADMAP C.17)")
    return net


def is_video_model(model: str) -> bool:
    """Models that consume (B, F, H, W, C) clips."""
    return model == "ConvNet3D" or model.startswith("VideoConvNet")


def get_eval_pool(eval_mode: str, model: str, model_eval: Optional[str] = None):
    """Parity with utils.py:973-996 (a copy of the JAX package's). The
    pools 'B' and 'N' name BatchNorm nets, which every path refuses
    (``path_model``, ROADMAP C.17)."""
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
