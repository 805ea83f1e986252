"""Kinetics-400 offline frame extraction (ffmpeg).

Copy of ``video_distillation_tpu/ingest/extract_k400.py``. Parity with the
reference's ``extract_frames/extract_k400.py``: probe each
video's duration with ffprobe, pick an adaptive fps so a middle window
yields ``num_frames`` frames at ``size`` x ``size``, write JPEG frame dirs,
and record short/broken videos in skip-lists (:15-50). Parallelised with a
process pool (:82-87). Requires ffmpeg/ffprobe on PATH; every call is
gated so the module imports cleanly without them.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import subprocess
from multiprocessing import get_context
from typing import Optional


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and \
        shutil.which("ffprobe") is not None


def probe_duration(path: str) -> Optional[float]:
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries", "format=duration",
             "-of", "json", path],
            capture_output=True, text=True, timeout=60)
        return float(json.loads(out.stdout)["format"]["duration"])
    except Exception:
        return None


def extract_one(src: str, dst_dir: str, num_frames: int = 16,
                size: int = 64, window_sec: float = 2.0):
    """Middle-window extraction at adaptive fps (extract_k400.py:15-50).

    Returns 'ok' | 'short' | 'broken'.
    """
    dur = probe_duration(src)
    if dur is None:
        return "broken"
    if dur < window_sec:
        return "short"
    start = max(0.0, dur / 2.0 - window_sec / 2.0)
    fps = num_frames / window_sec
    os.makedirs(dst_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-v", "error", "-ss", f"{start:.3f}",
           "-t", f"{window_sec:.3f}", "-i", src,
           "-vf", f"fps={fps},scale={size}:{size}",
           "-frames:v", str(num_frames),
           osp.join(dst_dir, "frame_%05d.jpg")]
    try:
        subprocess.run(cmd, capture_output=True, timeout=300, check=True)
    except Exception:
        return "broken"
    if len(os.listdir(dst_dir)) != num_frames:
        return "broken"
    return "ok"


def _work(args):
    src, dst, nf, size = args
    return (osp.basename(dst), extract_one(src, dst, nf, size))


def extract_split(video_dir: str, out_dir: str, num_frames: int = 16,
                  size: int = 64, workers: int = 8):
    """Extract every video file under ``video_dir``; writes skip-lists
    ``short_videos.txt`` / ``broken_videos.txt`` alongside
    (extract_k400.py:40-50)."""
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg/ffprobe not found on PATH")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for f in sorted(os.listdir(video_dir)):
        name = osp.splitext(f)[0]
        jobs.append((osp.join(video_dir, f), osp.join(out_dir, name),
                     num_frames, size))
    with get_context("spawn").Pool(workers) as pool:  # no fork of threads
        results = pool.map(_work, jobs)
    short = [n for n, s in results if s == "short"]
    broken = [n for n, s in results if s == "broken"]
    with open(osp.join(out_dir, "short_videos.txt"), "w") as f:
        f.write("\n".join(short))
    with open(osp.join(out_dir, "broken_videos.txt"), "w") as f:
        f.write("\n".join(broken))
    return results
