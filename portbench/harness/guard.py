"""What the benchmark's process must never load: JAX, its libraries and
the JAX package the port was made from, compared by whole top-level
module name (the part before the first dot)."""

from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "optax", "video_distillation_tpu")


def loaded(banned: Iterable[str] = BANNED) -> List[str]:
    """The banned top-level names among the loaded modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(banned))
