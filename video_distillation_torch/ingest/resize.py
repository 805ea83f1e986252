"""Offline frame-dir resize: resize(160x120) + centre-crop(112x112).

Copy of ``video_distillation_tpu/ingest/resize.py``. Parity with the
reference's ``distill_utils/resize_mydata.py`` (cv2-based
there; PIL here).
"""

from __future__ import annotations

import os
import os.path as osp

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def resize_frame_dir(src_dir: str, dst_dir: str, resize=(160, 120),
                     crop=112):
    os.makedirs(dst_dir, exist_ok=True)
    for f in sorted(os.listdir(src_dir)):
        img = Image.open(osp.join(src_dir, f)).convert("RGB")
        img = img.resize(resize, Image.BILINEAR)
        w, h = img.size
        left = (w - crop) // 2
        top = (h - crop) // 2
        img = img.crop((left, top, left + crop, top + crop))
        img.save(osp.join(dst_dir, f))


def resize_tree(src_root: str, dst_root: str, resize=(160, 120), crop=112):
    for d in sorted(os.listdir(src_root)):
        sd = osp.join(src_root, d)
        if osp.isdir(sd):
            resize_frame_dir(sd, osp.join(dst_root, d), resize, crop)
