"""Run one cell of the port's benchmark on this machine's CUDA card(s).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``, each number compared beside its limit, also the last lines
of standard error). Exits non-zero with no result where the card is
missing or the process loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
