"""Datasets: metadata, the numpy stores, the offline packer, the image
datasets and the synthetic test sets."""

from . import image_datasets
from .image_datasets import from_arrays, load_image_dataset, load_imagenet

__all__ = ["image_datasets", "from_arrays", "load_image_dataset",
           "load_imagenet"]
