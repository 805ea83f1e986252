"""The classic evaluation-pool image nets: MLP, LeNet, AlexNet(BN), VGG and
ResNet18 (BN, _AP).

Port of ``video_distillation_tpu/models/classic.py`` (structural parity
with the reference ``networks.py``: MLP :21-39, LeNet :119-140, AlexNet
:145-174, AlexNetBN :178-212, VGG :216-264, ResNet :383-500, ResNet_AP
:267-380). Input ``(B, H, W, C)`` (``layers.ImageModel``), NCHW inside,
the features flattened in the JAX (H, W, C) order; every net gives its
flattened penultimate features with ``output='feat'`` (the reference's
``embed``). 'instancenorm' is GroupNorm(C) with flax's epsilon,
'batchnorm' flax's BatchNorm at momentum 0.9. The module names follow the
flax tree (``jax_tree``), so ``distill/params.py`` carries JAX parameters
across.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (NORM_EPS, BatchNorm, GroupNorm, ImageModel, apply_norm,
                     avg_pool, max_pool, nhwc_flatten)


def _norm(norm: str, channels: int, device=None) -> nn.Module:
    if norm == "instancenorm":
        return GroupNorm(channels, channels, eps=NORM_EPS, device=device)
    if norm == "batchnorm":
        return BatchNorm(channels, momentum=0.9, device=device)
    raise ValueError(norm)


def _norm_kind(norm: str) -> str:
    return "BatchNorm" if norm == "batchnorm" else "GroupNorm"


class MLP(ImageModel):
    def __init__(self, channel: int = 3, num_classes: int = 10,
                 im_size: Tuple[int, int] = (32, 32), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d = channel * im_size[0] * im_size[1]
        self.fc = nn.ModuleList([nn.Linear(d, 128, device=device),
                                 nn.Linear(128, 128, device=device)])
        self.head = nn.Linear(128, num_classes, device=device)
        self.jax_tree = [(("TorchDense_0",), "fc.0", "torchdense"),
                         (("TorchDense_1",), "fc.1", "torchdense"),
                         (("TorchDense_2",), "head", "torchdense")]
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        out = nhwc_flatten(self.image_input(x))
        for fc in self.fc:
            out = F.relu(fc(out))
        return self.heads(out, output)


class LeNet(ImageModel):
    max_pools = True

    def __init__(self, channel: int = 3, num_classes: int = 10,
                 im_size: Tuple[int, int] = (32, 32), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        pad = 2 if channel == 1 else 0
        self.conv = nn.ModuleList([
            nn.Conv2d(channel, 6, 5, padding=pad, device=device),
            nn.Conv2d(6, 16, 5, device=device)])
        h, w = im_size
        h, w = (h + 2 * pad - 4) // 2, (w + 2 * pad - 4) // 2
        h, w = (h - 4) // 2, (w - 4) // 2
        self.fc = nn.ModuleList([nn.Linear(16 * h * w, 120, device=device),
                                 nn.Linear(120, 84, device=device)])
        self.head = nn.Linear(84, num_classes, device=device)
        self.jax_tree = [
            (("TorchConv_0",), "conv.0", "torchconv"),
            (("TorchConv_1",), "conv.1", "torchconv"),
            (("TorchDense_0",), "fc.0", "torchdense"),
            (("TorchDense_1",), "fc.1", "torchdense"),
            (("TorchDense_2",), "head", "torchdense")]
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = self.image_input(x)
        for conv in self.conv:
            x = max_pool(F.relu(conv(x)), (2, 2))
        x = nhwc_flatten(x)
        for fc in self.fc:
            x = F.relu(fc(x))
        return self.heads(x, output)


class AlexNet(ImageModel):
    max_pools = True
    # (features, kernel, padding, pool after) of the five blocks; the
    # first block's padding is 4 for 1-channel input
    BLOCKS = ((128, 5, 2, True), (192, 5, 2, True), (256, 3, 1, False),
              (192, 3, 1, False), (192, 3, 1, True))

    def __init__(self, channel: int = 3, num_classes: int = 10,
                 im_size: Tuple[int, int] = (32, 32), use_bn: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.use_bn = use_bn
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        self.pools = [pool for *_, pool in self.BLOCKS]
        cin, (h, w) = channel, im_size
        for i, (feats, k, pad, pool) in enumerate(self.BLOCKS):
            if i == 0 and channel == 1:
                pad = 4
            self.convs.append(nn.Conv2d(cin, feats, k, padding=pad,
                                        device=device))
            self.jax_tree.append(((f"TorchConv_{i}",), f"convs.{i}",
                                  "torchconv"))
            if use_bn:
                self.norms.append(BatchNorm(feats, momentum=0.9,
                                            device=device))
                self.jax_tree.append(((f"BatchNorm_{i}",), f"norms.{i}",
                                      "norm"))
            cin, h, w = feats, h + 2 * pad - k + 1, w + 2 * pad - k + 1
            if pool:
                h, w = h // 2, w // 2
        self.head = nn.Linear(cin * h * w, num_classes, device=device)
        self.jax_tree.append((("TorchDense_0",), "head", "torchdense"))
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = self.image_input(x)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.use_bn:
                x = self.norms[i](x, train)
            x = F.relu(x)
            if self.pools[i]:
                x = max_pool(x, (2, 2))
        return self.heads(nhwc_flatten(x), output)


CFG_VGG = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
              512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(ImageModel):
    max_pools = True

    def __init__(self, vgg_name: str = "VGG11", channel: int = 3,
                 num_classes: int = 10, im_size: Tuple[int, int] = (32, 32),
                 norm: str = "instancenorm", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = CFG_VGG[vgg_name]
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cin, (h, w) = channel, im_size
        for ic, item in enumerate(self.cfg):
            if item == "M":
                h, w = h // 2, w // 2
                continue
            i = len(self.convs)
            pad = 3 if (channel == 1 and ic == 0) else 1
            self.convs.append(nn.Conv2d(cin, item, 3, padding=pad,
                                        device=device))
            self.norms.append(_norm(norm, item, device))
            self.jax_tree += [((f"TorchConv_{i}",), f"convs.{i}", "torchconv"),
                              ((f"{_norm_kind(norm)}_{i}",), f"norms.{i}",
                               "norm")]
            cin, h, w = item, h + 2 * pad - 2, w + 2 * pad - 2
        self.head = nn.Linear(cin * h * w, num_classes, device=device)
        self.jax_tree.append((("TorchDense_0",), "head", "torchdense"))
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = self.image_input(x)
        i = 0
        for item in self.cfg:
            if item == "M":
                x = max_pool(x, (2, 2))
                continue
            x = F.relu(apply_norm(self.norms[i], self.convs[i](x), train))
            i += 1
        return self.heads(nhwc_flatten(x), output)


class BasicBlock(nn.Module):
    """The JAX ``_BasicBlock``: conv-norm-relu, conv-norm, plus the
    shortcut (a 1x1 conv and its norm where the stride or the width
    changes), relu. ``avg_pool_down`` (ResNet_AP, networks.py:270-297)
    downsamples by a 2x2 average pool after the first conv and after the
    shortcut's conv instead of striding."""

    def __init__(self, cin: int, planes: int, stride: int, norm: str,
                 avg_pool_down: bool, device=None):
        super().__init__()
        self.stride, self.avg_pool_down = stride, avg_pool_down
        conv_stride = 1 if avg_pool_down else stride
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=conv_stride, padding=1,
                               bias=False, device=device)
        self.norm1 = _norm(norm, planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False,
                               device=device)
        self.norm2 = _norm(norm, planes, device)
        kind = _norm_kind(norm)
        self.jax_tree = [(("TorchConv_0",), "conv1", "torchconv"),
                         ((f"{kind}_0",), "norm1", "norm"),
                         (("TorchConv_1",), "conv2", "torchconv"),
                         ((f"{kind}_1",), "norm2", "norm")]
        self.shortcut = stride != 1 or cin != planes
        if self.shortcut:
            self.conv_sc = nn.Conv2d(cin, planes, 1, stride=conv_stride,
                                     bias=False, device=device)
            self.norm_sc = _norm(norm, planes, device)
            self.jax_tree += [(("TorchConv_2",), "conv_sc", "torchconv"),
                              ((f"{kind}_2",), "norm_sc", "norm")]

    def forward(self, x, train: bool):
        out = F.relu(apply_norm(self.norm1, self.conv1(x), train))
        if self.avg_pool_down and self.stride != 1:
            out = avg_pool(out, (2, 2))
        out = apply_norm(self.norm2, self.conv2(out), train)
        shortcut = x
        if self.shortcut:
            shortcut = self.conv_sc(x)
            if self.avg_pool_down:
                shortcut = avg_pool(shortcut, (2, 2))
            shortcut = apply_norm(self.norm_sc, shortcut, train)
        return F.relu(out + shortcut)


class ResNet(ImageModel):
    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 channel: int = 3, num_classes: int = 10,
                 im_size: Tuple[int, int] = (32, 32),
                 norm: str = "instancenorm", avg_pool_down: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.avg_pool_down = avg_pool_down
        self.conv = nn.Conv2d(channel, 64, 3, padding=1, bias=False,
                              device=device)
        self.norm = _norm(norm, 64, device)
        self.jax_tree = [(("TorchConv_0",), "conv", "torchconv"),
                         ((f"{_norm_kind(norm)}_0",), "norm", "norm")]
        self.blocks = nn.ModuleList()
        cin, (h, w) = 64, im_size
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                num_blocks)):
            for s in [1 if stage == 0 else 2] + [1] * (n - 1):
                b = len(self.blocks)
                self.blocks.append(BasicBlock(cin, planes, s, norm,
                                              avg_pool_down, device))
                self.jax_tree += [((f"_BasicBlock_{b}",) + top,
                                   f"blocks.{b}.{name}", kind)
                                  for top, name, kind
                                  in self.blocks[-1].jax_tree]
                cin = planes
                if s != 1:
                    h, w = ((h // 2, w // 2) if avg_pool_down
                            else ((h - 1) // 2 + 1, (w - 1) // 2 + 1))
        if not avg_pool_down:
            h, w = h // 4, w // 4
        self.head = nn.Linear(cin * h * w, num_classes, device=device)
        self.jax_tree.append((("TorchDense_0",), "head", "torchdense"))
        self.reset_parameters(generator)

    def forward(self, x, train: bool = True, output: str = "logits", **_):
        x = F.relu(apply_norm(self.norm, self.conv(self.image_input(x)),
                              train))
        for block in self.blocks:
            x = block(x, train)
        if not self.avg_pool_down:
            # the reference ResNet's F.avg_pool2d(out, 4) (networks.py:468)
            x = avg_pool(x, (4, 4))
        return self.heads(nhwc_flatten(x), output)
