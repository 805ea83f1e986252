"""A cell's shapes, and the bytes each of the port's memory-bound kernels
must move at them.

Shapes (``Shapes``): ``compose`` clips of (frames, h, w) go through the
hallucinator's kernels in one launch; the first stage of ConvNet3D runs
on ``inner`` clips a launch, with ``width`` output channels; ``elem`` is
the byte size of the compute dtype. The first stage's GEMM output has N =
inner·frames·(h/4)·(w/4) rows of the four pool phases, 4·width wide; the
packed view is (inner, frames, h/2+4, w/2+4, 12·3).

A kernel's bytes: each input read once and each output written once (the
weights, a few hundred bytes, are left out). The entries of
``roofline/kernels/`` turn them, or a kernel's operations, into the
least time a launch can take.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


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


def hal_io(s: Shapes) -> Tuple[int, int, int]:
    """Elements of (still, motion, video) of the composed clips."""
    px = s.compose * s.h * s.w
    return px * 3, px * s.frames, px * s.frames * 3


def hal_fwd(s: Shapes) -> int:
    still, motion, video = hal_io(s)
    return (still + motion + video) * s.elem


def hal_dgrad(s: Shapes) -> int:
    """The motion's cotangent from the video's (the static is frozen)."""
    _, motion, video = hal_io(s)
    return (video + motion) * s.elem


def hal_wgrad(s: Shapes) -> int:
    still, motion, video = hal_io(s)
    return (still + motion + video) * s.elem


def video_elems(s: Shapes) -> int:
    return s.inner * s.frames * s.h * s.w * s.channels


def packed_elems(s: Shapes) -> int:
    return s.inner * s.frames * (s.h // 2 + 4) * (s.w // 2 + 4) * 12 * s.channels


def s2d2_move(s: Shapes) -> int:
    return (video_elems(s) + packed_elems(s)) * s.elem


def rows(s: Shapes) -> int:
    return s.inner * s.frames * (s.h // 4) * (s.w // 4)


def phase_trio(s: Shapes) -> int:
    """The GEMM's (N, 4·width) phases, the (N, width) winners and their
    uint8 phase index."""
    n = rows(s)
    return n * 4 * s.width * s.elem + n * s.width * s.elem + n * s.width
