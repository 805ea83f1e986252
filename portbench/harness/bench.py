"""One run of one cell: find its files by name, run its loop, read its
metrics, print the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file (``configs[].file``), its student net's reference
(``portbench/reference/nets/<model.name>.py``), the traffic mix
(``portbench/traffic/<traffic>.json``), the loop it names
(``portbench/loops/<loop>.py``), the limits of its checks
(``portbench/limits/<cell>.json``) and a reader for each metric
(``portbench/metrics/<metric>.py``, a ``read(run)`` that returns the number
or None); ``registry`` loads the Python files. A cell reports the
end-to-end metrics with ``--trace 0`` and the per-layer metrics with
``--trace 1``: those that list it, and those that list no cells wherever
their reader finds something to read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import torch

from . import guard, registry, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# build and kernel caches of the program, inside the checkout at fixed paths
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")


@dataclasses.dataclass
class Cell:
    name: str
    root: str
    chips: int
    config: dict
    net: object                   # reference/nets/<model.name>.py
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    """A metric that lists cells is reported in those; one that lists none,
    in every cell where its reader finds something to read."""
    return cell in metric.get("workloads", [cell])


def load_cell(root: str, workload: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r} (known: {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bdir = os.path.join(root, "portbench")
    config = _load_json(os.path.join(root, conf["file"]))
    return Cell(
        name=workload, root=root, chips=w["chips"], config=config,
        net=registry.find(root, "reference/nets", config["model"]["name"]),
        traffic=_load_json(os.path.join(bdir, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(bdir, "limits", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(root: str, name: str):
    return registry.find(root, "metrics", name).read


def loop(root: str, name: str):
    """The loop a traffic mix names: ``portbench/loops/<name>.py``."""
    return registry.find(root, "loops", name)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def program_seed(seed: int) -> int:
    """The seed the program gets: its outer-step generators take
    ``seed * 2**32 + it`` as a 64-bit seed."""
    return seed % 2 ** 32


def run_cell(root: str, args, t_start: float, device=None):
    """Run the cell; returns (exit code, result line or None). ``device``
    other than a CUDA card is for the tests, which skip the card check."""
    cell = load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3, None
        device = torch.device("cuda", 0)
    os.makedirs(CACHE_DIR, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(CACHE_DIR, sub))
    if device.type == "cuda":
        from video_distillation_torch.ops import build
        build.build_all()
    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = loop(root, cell.traffic["loop"]).run(
            cell, program_seed(args.seed), args.seconds, bool(args.trace),
            device, scratch, t_start)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    chosen = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loaded = guard.loaded(guard.BANNED)
    if loaded:
        print(f"portbench: the process loaded {loaded}", file=sys.stderr)
        return 4, None
    checks = {k: {"value": run.numbers.get(k, float("nan")), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (run.failed == 0 and run.attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
           else device.type,
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes,
           "power_limit_w": power_limit_w() if device.type == "cuda" else None}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if args.trace and run.digest is not None:
        dev["busy_s"] = run.digest.busy_us / 1e6
        dev["window_s"] = run.digest.window_us / 1e6
        line["breakdown"] = tracing.breakdown(run.digest)
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, line


def main(argv=None, t_start: float = 0.0) -> int:
    args = parse(argv)
    rc, line = run_cell(ROOT, args, t_start)
    if line is not None:
        sys.stdout.flush()
        print(json.dumps(line), flush=True)
    return rc
