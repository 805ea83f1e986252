"""The port stands alone: no file of ``video_distillation_torch`` and no line
of ``chip_smoke.py`` imports ``jax``, ``flax`` or ``video_distillation_tpu``,
and every module of the package imports with those blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "video_distillation_tpu")
SOURCES = sorted((ROOT / "video_distillation_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    text = path.read_text()
    for name in ("__import__(\"jax", "import_module(\"jax",
                 "import_module(\"video_distillation_tpu"):
        assert name not in text


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "import video_distillation_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 55
    # static learning, packing, the baselines, FRePo, the image side,
    # augmentation and profiling, which need no JAX either
    assert {f"video_distillation_torch.{m}" for m in (
        "models.convnet2d", "ops.losses", "distill.dc", "distill.dm",
        "drivers.distill_static", "data.packer", "drivers.pack",
        "ingest.extract_k400", "ingest.extract_ssv2", "ingest.resize",
        "distill.coreset", "drivers.distill_baseline",
        "drivers.distill_coreset", "distill.frepo",
        "drivers.distill_frepo", "data.image_datasets", "ops.zca", "ops.ema",
        "models.classic", "models.frepo_nets", "ops.augment",
        "ops.augment_extra", "ops.augmax_ops", "utils.profiling",
        "parallel", "parallel.dist")} <= names


def test_parallel_imports_and_runs_with_jax_blocked():
    """The data-parallel layer needs no JAX: without a launcher it is world
    size 1, and a gloo group of one rank sums as the identity."""
    code = (
        "import os, sys, tempfile\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch, torch.distributed as d\n"
        "from video_distillation_torch import parallel\n"
        "assert parallel.init_distributed('cpu') is False\n"
        "assert parallel.world_size() == 1 and parallel.is_coordinator()\n"
        "f = os.path.join(tempfile.mkdtemp(), 'g')\n"
        "d.init_process_group('gloo', init_method='file://' + f, rank=0,\n"
        "                     world_size=1)\n"
        "t = parallel.all_reduce_(torch.arange(3.0))\n"
        "assert t.tolist() == [0.0, 1.0, 2.0] and parallel.active()\n"
        "assert parallel.STATS == {'all_reduce': 1, 'broadcast': 0,\n"
        "                          'bytes': 12}\n"
        "d.destroy_process_group()\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]
