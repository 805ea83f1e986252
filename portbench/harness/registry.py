"""Files found by name. Everything a cell is made of lives in a file of its
own under ``portbench/``, loaded with ``importlib`` from the name that
``BENCHMARK.json``, a configuration or a traffic mix gives:

* ``metrics/<metric>.py``: ``read(run)``, the metric's value or None;
* ``loops/<loop>.py`` (a traffic mix's ``"loop"``): ``run(cell, seed,
  seconds, trace, device, scratch, t_start, first_only=False)``, the
  record of one run (``first_only``: compare the window's first step or
  call, for ``calibrate.py``), and ``stand_in(cell, seed, device, who)``,
  the compared numbers of a control or a fault in the program's place
  (``harness/stand_ins.py``; ``calibrate.py`` alone calls it);
* ``reference/nets/<model.name>.py`` (a configuration's ``model.name``):
  the plain reference of the student net, each function reading the
  net's widths from the configuration's ``model``;
* ``roofline/kernels/<counter>.py``, one for each launch counter of the
  program's ops with a roofline: ``PATTERN``, a pattern of the device
  kernels' names, and ``bound(shapes, config, peaks)``, the least seconds
  a launch can take.

So a configuration, a traffic mix, a loop, a student net, a kernel's
roofline and a metric are each added as new files: no file that exists
is edited. A file is loaded once a process.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from typing import Dict

_LOADED: Dict[str, object] = {}


def load(path: str):
    """The module of the Python file at ``path``."""
    path = os.path.abspath(path)
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"portbench: no file {path}")
        name = "_portbench_" + re.sub(r"\W", "_", path)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
        _LOADED[path] = mod
    return _LOADED[path]


def find(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``."""
    return load(os.path.join(root, "portbench", kind, f"{name}.py"))


def every(root: str, kind: str) -> Dict[str, object]:
    """{name: module} of every file in ``portbench/<kind>/`` under
    ``root``, by name."""
    folder = os.path.join(root, "portbench", kind)
    return {f[:-3]: load(os.path.join(folder, f))
            for f in sorted(os.listdir(folder)) if f.endswith(".py")}
