"""Dataset metadata registry.

A copy of ``video_distillation_tpu/data/meta.py`` (the port imports nothing
of the JAX package).

Parity with the reference ``get_dataset`` constants
(the reference's ``utils.py:21-460``): channel count, resolution, class
count, ImageNet normalisation stats, and default frame counts per dataset.
The torchvision-lineage image datasets (MNIST..ImageNet) are represented so
the 2D model pools / static-memory learning have data; the video datasets
are the first-class citizens.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# reference distill_utils/dataset.py:15-16
NUM_FRAMES = 16
FRAME_GAP = 4


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    name: str
    channel: int
    im_size: Tuple[int, int]
    num_classes: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    frames: int = 1  # 1 for image datasets
    class_names: Optional[List[str]] = None

    @property
    def is_video(self) -> bool:
        return self.frames > 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["im_size"] = list(self.im_size)
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "DatasetMeta":
        d = json.loads(s)
        d["im_size"] = tuple(d["im_size"])
        d["mean"] = tuple(d["mean"])
        d["std"] = tuple(d["std"])
        return DatasetMeta(**d)


def _video(name, num_classes, im_size=(112, 112), frames=NUM_FRAMES):
    return DatasetMeta(name=name, channel=3, im_size=im_size,
                       num_classes=num_classes, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, frames=frames)


_REGISTRY = {
    # video datasets (utils.py:132-235, :441-455)
    "miniUCF101": _video("miniUCF101", 50),
    "UCF101": _video("UCF101", 101),
    "HMDB51": _video("HMDB51", 51),
    "Kinetics400": _video("Kinetics400", 400, im_size=(64, 64), frames=8),
    "Kinetics400_long": _video("Kinetics400_long", 400, im_size=(112, 112)),
    "SSv2": _video("SSv2", 174, im_size=(64, 64), frames=8),
    # static variants — boring videos: one frame repeated F times
    # (dataset.py:570-839); same shapes as their parents
    "staticUCF50": _video("staticUCF50", 50),
    "staticUCF101": _video("staticUCF101", 101),
    "staticHMDB51": _video("staticHMDB51", 51),
    "staticKinetics400": _video("staticKinetics400", 400, im_size=(64, 64),
                                frames=8),
    "staticSSv2": _video("staticSSv2", 174, im_size=(64, 64), frames=8),
    # single-frame (image) variants for DC static-memory learning
    # (dataset.py:18-77, :897-946)
    "singleUCF50": DatasetMeta("singleUCF50", 3, (112, 112), 50,
                               IMAGENET_MEAN, IMAGENET_STD),
    "singleHMDB51": DatasetMeta("singleHMDB51", 3, (112, 112), 51,
                                IMAGENET_MEAN, IMAGENET_STD),
    "singleKinetics400": DatasetMeta("singleKinetics400", 3, (64, 64), 400,
                                     IMAGENET_MEAN, IMAGENET_STD),
    "singleSSv2": DatasetMeta("singleSSv2", 3, (64, 64), 174,
                              IMAGENET_MEAN, IMAGENET_STD),
    # DC-lineage image datasets (utils.py:26-130)
    "MNIST": DatasetMeta("MNIST", 1, (28, 28), 10, (0.1307,), (0.3081,)),
    "FashionMNIST": DatasetMeta("FashionMNIST", 1, (28, 28), 10, (0.2861,),
                                (0.3530,)),
    "SVHN": DatasetMeta("SVHN", 3, (32, 32), 10,
                        (0.4377, 0.4438, 0.4728), (0.1980, 0.2010, 0.1970)),
    "CIFAR10": DatasetMeta("CIFAR10", 3, (32, 32), 10,
                           (0.4914, 0.4822, 0.4465),
                           (0.2470, 0.2435, 0.2616)),
    "CIFAR100": DatasetMeta("CIFAR100", 3, (32, 32), 100,
                            (0.5071, 0.4866, 0.4409),
                            (0.2673, 0.2564, 0.2762)),
    # full ImageNet at 64^2 with the standard ImageNet stats
    # (utils.py:105-131)
    "ImageNet": DatasetMeta("ImageNet", 3, (64, 64), 1000,
                            IMAGENET_MEAN, IMAGENET_STD),
    # FRePo image sets (FRePo/lib/dataset/dataloader.py:14-26 stats;
    # imagenette/imagewoof at 128^2, tiny-imagenet at 64^2)
    "imagenette": DatasetMeta("imagenette", 3, (128, 128), 10,
                              (0.4626, 0.4588, 0.4251),
                              (0.2790, 0.2745, 0.2973)),
    "imagewoof": DatasetMeta("imagewoof", 3, (128, 128), 10,
                             (0.4917, 0.4613, 0.3931),
                             (0.2513, 0.2442, 0.2530)),
    "tiny_imagenet": DatasetMeta("tiny_imagenet", 3, (64, 64), 200,
                                 (0.4759, 0.4481, 0.3926),
                                 (0.2763, 0.2687, 0.2813)),
}


def get_meta(name: str) -> DatasetMeta:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset: {name} "
                       f"(known: {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def register_meta(meta: DatasetMeta):
    """Register a custom dataset (used by tests / synthetic data)."""
    _REGISTRY[meta.name] = meta
