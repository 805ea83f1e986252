"""ConvNet3D's second-stage forward on the tensor cores
(``conv3d_s2_fprop_kernel``): Conv3d k (3, 7, 7), stride (1, 2, 2),
``first_width`` -> ``net_width`` channels, bf16 in, fp32 sums.

Bound by its operations: 2·M·N·K at the card's dense bf16 peak, with M =
inner·frames·(h/8)·(w/8) output positions, N = ``net_width`` and K =
``first_width``·3·7·7 (377.6 GFLOP, 0.382 ms at ucf; 315.7 GFLOP, 0.319
ms at k400). Every launch is the second stage's at the benchmark's cells:
the third stage's GEMM (M 6,400 at ucf, 4,096 at k400) is under the
route's gate of 16,384 rows and stays on cuDNN.
"""

import math

PATTERN = r"conv3d_s2_fprop"


def bound(s, config, peaks) -> float:
    """Seconds: the launch's GEMM at the card's bf16 peak."""
    m = config["model"]
    rows = s.inner * s.frames * (s.h // 8) * (s.w // 8)
    k = m["first_width"] * math.prod(m["kernel"])
    return 2 * rows * m["net_width"] * k / peaks["bfloat16"]
