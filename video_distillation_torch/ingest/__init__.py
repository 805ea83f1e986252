"""Offline frame extraction (ffmpeg, PIL) and resizing: copies of
``video_distillation_tpu/ingest``."""

from .extract_ssv2 import evenly_spaced

__all__ = ["evenly_spaced"]
