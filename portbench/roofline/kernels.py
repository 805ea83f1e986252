"""Bytes each of the port's nine kernels must move, from a cell's shapes.

The bound of a launch is its bytes at the card's memory bandwidth: each
input read once and each output written once (the weights, a few hundred
bytes, are left out). ``KERNELS`` maps each launch counter of the port's
``ops`` modules to the device kernels that serve it (a pattern of their
names) and to its bytes per launch.

Shapes (``Shapes``): ``compose`` clips of (frames, h, w) go through the
hallucinator's kernels in one launch; the first stage of ConvNet3D runs
on ``inner`` clips a launch, with ``width`` output channels; ``elem`` is
the byte size of the compute dtype. The first stage's GEMM output has N =
inner·frames·(h/4)·(w/4) rows of the four pool phases, 4·width wide; the
packed view is (inner, frames, h/2+4, w/2+4, 12·3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Shapes:
    compose: int
    inner: int
    frames: int
    h: int
    w: int
    elem: int
    width: int = 64
    channels: int = 3


def _hal_io(s: Shapes) -> Tuple[int, int, int]:
    """Elements of (still, motion, video) of the composed clips."""
    px = s.compose * s.h * s.w
    return px * 3, px * s.frames, px * s.frames * 3


def hal_fwd(s: Shapes) -> int:
    still, motion, video = _hal_io(s)
    return (still + motion + video) * s.elem


def hal_dgrad(s: Shapes) -> int:
    """The motion's cotangent from the video's (the static is frozen)."""
    _, motion, video = _hal_io(s)
    return (video + motion) * s.elem


def hal_wgrad(s: Shapes) -> int:
    still, motion, video = _hal_io(s)
    return (still + motion + video) * s.elem


def _video(s: Shapes) -> int:
    return s.inner * s.frames * s.h * s.w * s.channels


def _packed(s: Shapes) -> int:
    return s.inner * s.frames * (s.h // 2 + 4) * (s.w // 2 + 4) * 12 * s.channels


def s2d2_move(s: Shapes) -> int:
    return (_video(s) + _packed(s)) * s.elem


def _rows(s: Shapes) -> int:
    return s.inner * s.frames * (s.h // 4) * (s.w // 4)


def phase_trio(s: Shapes) -> int:
    """The GEMM's (N, 4·width) phases, the (N, width) winners and their
    uint8 phase index."""
    n = _rows(s)
    return n * 4 * s.width * s.elem + n * s.width * s.elem + n * s.width


KERNELS: Dict[str, Tuple[str, Callable[[Shapes], int]]] = {
    "hal_fwd": (r"hal_fwd", hal_fwd),
    "hal_dgrad": (r"hal_dgrad", hal_dgrad),
    "hal_wgrad": (r"hal_wgrad", hal_wgrad),
    "hal_fused": (r"hal_fused", hal_fwd),
    "phase_argmax": (r"phase_argmax", phase_trio),
    "phase_select": (r"phase_select", phase_trio),
    "phase_scatter": (r"phase_scatter", phase_trio),
    "s2d2_pack": (r"s2d2_pack", s2d2_move),
    "s2d2_unpack": (r"s2d2_unpack", s2d2_move),
}


def bound_seconds(kernel: str, s: Shapes, bytes_per_s: float) -> float:
    return KERNELS[kernel][1](s) / bytes_per_s
