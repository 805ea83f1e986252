"""Synthetic random datasets for tests and benchmarks.

The reference has no test fixtures; we follow SURVEY.md §4's plan: a tiny
random-frame video dataset drives end-to-end DM/MTT/S2D smoke tests in
minutes on CPU.
"""

from __future__ import annotations

import numpy as np

from .meta import DatasetMeta, IMAGENET_MEAN, IMAGENET_STD, register_meta
from .store import ClipStore, RaggedFrameStore, VideoData


def synthetic_kwargs_from_name(name: str) -> dict:
    """Parse a parameterised synthetic dataset name.

    ``synthetic[_c<classes>][_n<clips/class>][_t<test/class>][_f<frames>]
    [_im<px>][_seed<s>]`` — e.g. ``synthetic_c10_n24_f8_im64`` is a
    10-class, 24-clips-per-class, 8-frame, 64px set. Lets functional
    validation runs at larger scales be plain CLI invocations.
    """
    kw = {}
    for tok in name.split("_")[1:]:
        if tok.startswith("im"):
            kw["im_size"] = (int(tok[2:]), int(tok[2:]))
        elif tok.startswith("seed"):
            kw["seed"] = int(tok[4:])
        elif tok.startswith("c"):
            kw["num_classes"] = int(tok[1:])
        elif tok.startswith("n"):
            kw["clips_per_class"] = int(tok[1:])
        elif tok.startswith("t"):
            kw["test_per_class"] = int(tok[1:])
        elif tok.startswith("f"):
            kw["frames"] = int(tok[1:])
        else:
            raise ValueError(f"unknown synthetic-name token: {tok!r}")
    return kw


def make_synthetic_video_data(num_classes: int = 3, clips_per_class: int = 6,
                              test_per_class: int = 4, frames: int = 8,
                              im_size=(64, 64), test_video_len: int = 40,
                              seed: int = 0, class_sep: float = 1.0,
                              noise: float = 30.0,
                              name: str = "synthetic") -> VideoData:
    """``class_sep`` scales how far class means sit from mid-gray and
    ``noise`` the per-pixel jitter: class_sep=1 is trivially separable
    (smoke tests); ~0.15-0.3 with noise ~45 gives mid-range accuracies
    so statistical band comparisons (parity harness) carry signal."""
    rng = np.random.default_rng(seed)
    meta = DatasetMeta(name=name, channel=3, im_size=tuple(im_size),
                       num_classes=num_classes, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, frames=frames)
    register_meta(meta)

    h, w = im_size
    n_train = num_classes * clips_per_class
    # class-dependent mean so distillation/eval have signal to find
    class_mu = 127.5 + class_sep * (
        rng.integers(40, 215, size=(num_classes, 3)) - 127.5)

    def make_clip(c, f):
        base = class_mu[c][None, None, None, :] + rng.normal(
            0, noise, size=(f, h, w, 3))
        return np.clip(base, 0, 255).astype(np.uint8)

    train_clips = np.stack([
        make_clip(c, frames) for c in range(num_classes)
        for _ in range(clips_per_class)
    ])
    train_labels = np.repeat(np.arange(num_classes), clips_per_class)

    n_test = num_classes * test_per_class
    test_videos = [make_clip(c, test_video_len) for c in range(num_classes)
                   for _ in range(test_per_class)]
    offsets = np.zeros(n_test + 1, np.int64)
    offsets[1:] = np.cumsum([v.shape[0] for v in test_videos])
    test_frames = np.concatenate(test_videos, axis=0)
    test_labels = np.repeat(np.arange(num_classes), test_per_class)

    return VideoData(
        meta=meta,
        train=ClipStore(train_clips, train_labels, meta),
        test=RaggedFrameStore(test_frames, offsets,
                              test_labels.astype(np.int32), meta),
    )
