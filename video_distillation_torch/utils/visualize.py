"""Distilled-set visualization: PNG grids of statics / dynamics / videos.

Port of ``video_distillation_tpu/utils/visualize.py`` (capability parity
with the reference's ``save_frepo_image``,
the reference code's ``FRePo/lib/datadistillation/utils.py:40-118``). Videos
render as one row per clip with frames as columns. The PNG files are
written with the standard library (``zlib`` + ``struct``), so the grids
need no imaging package.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from ..parallel import dist


def scale_for_vis(x: np.ndarray, mean: Optional[Sequence[float]] = None,
                  std: Optional[Sequence[float]] = None) -> np.ndarray:
    """Map a distilled tensor to [0, 1] for display.

    With dataset stats, invert the (img - mean)/std normalization the
    synthetic tensors are optimized in; otherwise use the reference's
    std-rescale ``img/img.std()*0.2 + 0.5`` (utils.py:42-48).
    """
    x = np.asarray(x, np.float32)
    if mean is not None and std is not None:
        x = x * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    else:
        s = float(x.std())
        x = x / (s if s > 0 else 1.0) * 0.2 + 0.5
    return np.clip(x, 0.0, 1.0)


def _to_grid(images: np.ndarray, ncol: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) floats in [0,1] -> one (GH, GW, 3) uint8 grid array."""
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[..., None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    n, h, w, _ = images.shape
    ncol = max(1, min(ncol, n))
    nrow = -(-n // ncol)
    grid = np.zeros((nrow * (h + pad) + pad, ncol * (w + pad) + pad, 3),
                    np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y0, x0 = pad + r * (h + pad), pad + c * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return (grid * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _save_png(path: str, grid_u8: np.ndarray) -> None:
    """An 8-bit RGB PNG: every scanline with filter type 0, one IDAT;
    written by the coordinator only."""
    if not dist.is_coordinator():
        return
    h, w, _ = grid_u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(grid_u8).reshape(h, w * 3)],
                          axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def save_image_grid(path: str, images, mean=None, std=None,
                    ncol: int = 10, max_images: int = 100) -> str:
    """Save up to ``max_images`` stills (N, H, W, C) as a PNG grid
    (reference caps at 100 / 10 per row — utils.py:69-83)."""
    images = np.asarray(images)[:max_images]
    _save_png(path, _to_grid(scale_for_vis(images, mean, std), ncol))
    return path


def save_video_grid(path: str, videos, mean=None, std=None,
                    max_videos: int = 10, max_frames: int = 8) -> str:
    """Save clips (N, F, H, W, C) as a PNG grid: one row per clip,
    frames as columns (temporally subsampled to ``max_frames``)."""
    videos = np.asarray(videos)[:max_videos]
    n, f = videos.shape[:2]
    stride = max(1, f // max_frames)
    sel = videos[:, ::stride][:, :max_frames]
    flat = sel.reshape((-1,) + sel.shape[2:])
    _save_png(path, _to_grid(scale_for_vis(flat, mean, std),
                             ncol=sel.shape[1]))
    return path


def save_s2d_grids(save_dir: str, step: int, static=None, dynamic=None,
                   videos=None, mean=None, std=None) -> list:
    """Write the S2D artifact grids for one save point under
    ``save_dir/png/``: static memory stills, dynamic memory volumes
    (1-channel, shown with the std-rescale), composed videos."""
    out = []
    png_dir = os.path.join(save_dir, "png")
    tag = str(step).zfill(6)
    if static is not None:
        out.append(save_image_grid(
            os.path.join(png_dir, f"static_{tag}.png"), static, mean, std))
    if dynamic is not None:
        dyn = np.asarray(dynamic)
        dyn = dyn.reshape((-1,) + dyn.shape[-4:])  # (N, F, H, W, 1)
        out.append(save_video_grid(
            os.path.join(png_dir, f"dynamic_{tag}.png"), dyn))
    if videos is not None:
        out.append(save_video_grid(
            os.path.join(png_dir, f"videos_{tag}.png"), videos, mean, std))
    return out
