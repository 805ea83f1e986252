"""A toy cell for CPU tests: a copy of the benchmark's files with a small
configuration (3 classes, 64x64x8), traffic and limits added beside the
real ones, so no file that exists is edited."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOY_CONFIG = {
    "name": "toy_c3_s2d", "dataset": "toy_c3", "source": "test",
    "model": {"name": "ConvNet3D", "channel": 3, "num_classes": 3,
              "im_size": 64, "frames": 8, "first_width": 64,
              "net_width": 128, "net_depth": 3, "kernel": [3, 7, 7],
              "dropout": 0.5},
    "distill": {"method": "MTT", "spc": 2, "dpc": 2, "vpc": 1, "n_hal": 1,
                "no_train_static": True, "train_lr": True, "syn_steps": 2,
                "expert_epochs": 1, "max_start_epoch": 2, "lr_teacher": 0.01,
                "lr_static": 100.0, "lr_dynamic": 0.01, "lr_hal": 0.01,
                "lr_lr": 1e-05, "batch_syn": None, "Iteration": 10000,
                "eval_it": 400, "startIt": 400, "compute_dtype": "float32",
                "second_order": "rof"},
    "eval": {"num_eval": 2, "epoch_eval_train": 2, "batch_train": 256,
             "lr_net": 0.01, "eval_mode": "SS"},
    "flops": {"outer_step": 1.0, "eval_net_step": 1.0},
    "reduced": [],
}
TOY_TRAFFIC = {
    "toy_distill": {"loop": "distill_s2d", "experts": 2, "snapshots": 3},
    "toy_eval_vmap": {"loop": "eval_train", "vmap": True},
    "toy_eval_seq": {"loop": "eval_train", "vmap": False},
}
# the benchmark's own limits: a toy cell is held to the first cells' limits
LIMITS_OF = {"toy_distill": "ucf_s2d_mtt", "toy_eval_vmap": "ucf_eval_vmap",
             "toy_eval_seq": "ucf_eval_seq"}
TOY_METRIC = '''"""The toy cell's own metric: its work units in the window."""


def read(run):
    return run.units
'''


def make_copy(dest: str) -> str:
    """Copy BENCHMARK.json and portbench/ to ``dest`` and add the toy
    configuration, its cells, traffic, limits and one metric. Returns the
    copy's root; the program under test stays importable from ROOT."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dest, "portbench")
    with open(os.path.join(pb, "configs", "toy_c3_s2d.json"), "w") as f:
        json.dump(TOY_CONFIG, f)
    bench["configs"].append({"name": "toy_c3_s2d", "source": "test",
                             "file": "portbench/configs/toy_c3_s2d.json",
                             "reduced": [], "why": "a CPU test"})
    for name, traffic in TOY_TRAFFIC.items():
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as f:
            json.dump(traffic, f)
        shutil.copy(os.path.join(pb, "limits", f"{LIMITS_OF[name]}.json"),
                    os.path.join(pb, "limits", f"{name}.json"))
        bench["workloads"].append({"name": name, "config": "toy_c3_s2d",
                                   "traffic": name, "chips": 1,
                                   "why": "a CPU test"})
    with open(os.path.join(pb, "metrics", "toy_units.py"), "w") as f:
        f.write(TOY_METRIC)
    bench["end_to_end"].append({"name": "toy_units", "unit": "steps",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": list(TOY_TRAFFIC)})
    for m in bench["end_to_end"]:
        if m["name"] in ("outer_steps_per_s", "eval_net_steps_per_s"):
            m["workloads"] += [n for n in TOY_TRAFFIC
                               if ("distill" in n) == (m["name"][0] == "o")]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest
