"""Something-Something-v2 offline frame extraction.

Copy of ``video_distillation_tpu/ingest/extract_ssv2.py``. Parity with the
reference's ``extract_frames/extract_sthsth.py``: decode
each webm, select ``num_frames`` evenly-spaced frames, resize to
``size`` x ``size`` with PIL, and write ``annot_{split}.json`` +
``class_list.json`` (:41-95).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import subprocess
from typing import List

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def evenly_spaced(n_total: int, n_pick: int) -> List[int]:
    """Evenly-spaced frame indices (extract_sthsth.py selection rule)."""
    if n_total <= n_pick:
        return list(range(n_total)) + [n_total - 1] * (n_pick - n_total)
    step = n_total / n_pick
    return [int(i * step) for i in range(n_pick)]


def extract_one(src: str, dst_dir: str, num_frames: int = 8,
                size: int = 64) -> bool:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    tmp = dst_dir + "_tmp"
    os.makedirs(tmp, exist_ok=True)
    try:
        subprocess.run(["ffmpeg", "-y", "-v", "error", "-i", src,
                        osp.join(tmp, "f_%06d.jpg")],
                       capture_output=True, timeout=300, check=True)
        files = sorted(os.listdir(tmp))
        if not files:
            return False
        os.makedirs(dst_dir, exist_ok=True)
        for out_i, src_i in enumerate(evenly_spaced(len(files), num_frames)):
            img = Image.open(osp.join(tmp, files[src_i])).convert("RGB")
            img = img.resize((size, size), Image.BILINEAR)
            img.save(osp.join(dst_dir, "frame_%05d.jpg" % out_i))
        return True
    except Exception:
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_annotations(label_json: str, out_dir: str, split: str):
    """Write annot_{split}.json + class_list.json from the official SSv2
    label files (extract_sthsth.py:41-95)."""
    with open(label_json) as f:
        items = json.load(f)
    annots = [{"id": it["id"], "label": it["template"].replace(
        "[", "").replace("]", "")} for it in items]
    classes = sorted({a["label"] for a in annots})
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, f"annot_{split}.json"), "w") as f:
        json.dump(annots, f)
    cl_path = osp.join(out_dir, "class_list.json")
    if not osp.exists(cl_path):
        with open(cl_path, "w") as f:
            json.dump(classes, f)
    return annots, classes
