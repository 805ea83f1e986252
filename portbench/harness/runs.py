"""What the loops share (each loop is a file of ``portbench/loops/``): the
record of one run, the device helpers, the program's counters, and the
hook that keeps the student net's first forward.

Each loop runs the window (until ``seconds`` have passed and the units it
compares are done), reads the memory, frees the program's state and then
runs the reference on what the window produced; ``record`` makes the
``Run`` the metric readers read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import pkgutil
from typing import Dict, Optional

import torch

from ..roofline.peaks import card_peaks
from ..roofline.shapes import Shapes
from .tracing import Digest


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""
    unit: str                      # 'outer_step' or 'eval_net_step'
    setup_s: float
    window_s: float
    units: float
    attempted: int
    failed: int
    window_peak_bytes: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    digest: Optional[Digest]
    flops_per_unit: float
    peak_flops: float
    peaks: Dict[str, float]        # roofline.peaks.card_peaks of the card
    shapes: Shapes
    root: str                      # the checkout whose files the cell named
    config: dict                   # the cell's configuration


class WindowClosed(Exception):
    pass


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> Dict[str, int]:
    """The launch counters (``LAUNCHES``) of every module of the program's
    ``ops`` that has them."""
    from video_distillation_torch import ops
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        out.update(getattr(mod, "LAUNCHES", {}))
    return out


def counts() -> Dict[str, int]:
    """The program's transfer counters (``utils/profiling.COUNTS``:
    ``host_syncs``, ``h2d_bytes``); none where it has no such counters."""
    from video_distillation_torch.utils import profiling
    return dict(getattr(profiling, "COUNTS", {}))


def plain(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under functorch's wrappers (a net's output inside
    ``vmap(grad(...))``), the mapped dimension first."""
    from torch._C import _functorch as ft
    while ft.is_gradtrackingtensor(t) or ft.is_batchedtensor(t):
        if ft.is_batchedtensor(t):
            t = ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0)
        else:
            t = ft.get_unwrapped(t)
    return t


class FirstForward:
    """While armed, keeps the logits of the student net's first forward:
    the first module call that returns (rows, classes), read through a
    global forward hook as the program runs."""

    def __init__(self, classes: int):
        self.classes, self.handle, self.logits = classes, None, None

    def arm(self):
        self.logits = None
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self._hook)

    def disarm(self) -> Optional[torch.Tensor]:
        if self.handle is not None:
            self.handle.remove()
            self.handle = None
        return self.logits

    def _hook(self, module, args, out):
        if (self.logits is None and isinstance(out, torch.Tensor)
                and out.dim() == 2 and out.shape[-1] == self.classes):
            self.logits = plain(out).detach().float().clone()


def meta(conf):
    """The dataset's description as the configuration's file gives it."""
    from video_distillation_torch.data.meta import (IMAGENET_MEAN,
                                                    IMAGENET_STD, DatasetMeta)
    m = conf["model"]
    return DatasetMeta(name=conf["dataset"], channel=m["channel"],
                       im_size=(m["im_size"], m["im_size"]),
                       num_classes=m["num_classes"], mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, frames=m["frames"])


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def record(cell, unit, marks, win, attempted, failed, window_peak, numbers,
           dtype, shapes, device) -> Run:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    peaks = card_peaks(name)
    return Run(unit=unit, setup_s=marks["setup_s"], window_s=win.elapsed,
               units=win.units, attempted=attempted, failed=failed,
               window_peak_bytes=window_peak,
               memory_peak_bytes=max(window_peak, marks["setup_peak"]),
               numbers=numbers, digest=win.digest,
               flops_per_unit=float(cell.config["flops"][unit]),
               peak_flops=peaks[dtype], peaks=peaks, shapes=shapes,
               root=cell.root, config=cell.config)
