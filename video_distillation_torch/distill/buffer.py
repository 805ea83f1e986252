"""Expert trajectory buffers.

Port of ``load_buffers`` from ``video_distillation_tpu/distill/buffer.py``
(:187-203). The files are the JAX package's ``replay_buffer_{n}.npz``;
training experts to write them is not ported yet (ROADMAP A.5).
"""

from __future__ import annotations

import os

from .mtt import TrajectoryBuffer


def load_buffers(buffer_path: str) -> list:
    """Load all replay_buffer_{n}.npz files (distill_baseline.py:122-128)."""
    if not buffer_path:
        raise ValueError(
            "MTT requires expert trajectories: pass --buffer_path pointing "
            "at a directory of replay_buffer_{n}.npz files (generate them "
            "with python -m video_distillation_tpu.drivers.buffer)")
    buffers = []
    n = 0
    while os.path.exists(os.path.join(buffer_path,
                                      f"replay_buffer_{n}.npz")):
        buffers.append(TrajectoryBuffer.load(
            os.path.join(buffer_path, f"replay_buffer_{n}.npz")))
        n += 1
    if not buffers:
        raise FileNotFoundError(f"No buffers detected at {buffer_path}")
    return buffers
