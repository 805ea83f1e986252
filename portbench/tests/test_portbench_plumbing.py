"""A configuration, a traffic mix and a metric are files found by name:
a toy cell added to a copy of the benchmark runs through the harness with
no file that exists edited (BENCHMARK.json only gains entries)."""

import hashlib
import json
import os
import time

import pytest
import torch

from portbench.harness import bench

ROOT = bench.ROOT


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_copy_edits_no_file(toy_root):
    src = os.path.join(ROOT, "portbench")
    for d, _, files in os.walk(src):
        if "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert _digest(os.path.join(ROOT, rel)) == _digest(
                os.path.join(toy_root, rel)), rel
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        ours = json.load(f)
    with open(os.path.join(toy_root, "BENCHMARK.json")) as f:
        theirs = json.load(f)
    for key in ("configs", "workloads", "per_layer"):
        assert theirs[key][:len(ours[key])] == ours[key]
    for a, b in zip(ours["end_to_end"], theirs["end_to_end"]):
        assert {k: v for k, v in a.items() if k != "workloads"} == {
            k: v for k, v in b.items() if k != "workloads"}
        assert b.get("workloads", [])[:len(a.get("workloads", []))] == a.get(
            "workloads", [])


@pytest.mark.parametrize("workload,rate", [
    ("toy_distill", "outer_steps_per_s"),
    ("toy_eval_vmap", "eval_net_steps_per_s")])
def test_a_toy_cell_runs_through_the_harness(toy_root, workload, rate):
    args = bench.parse(["--workload", workload, "--seed", str(2 ** 31 + 3),
                        "--seconds", "0.5", "--trace", "0"])
    rc, line = bench.run_cell(toy_root, args, time.perf_counter(),
                              device=torch.device("cpu"))
    assert rc == 0 and line["correct"], line
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {rate, "setup_s", "toy_units"}
    assert line["metrics"]["toy_units"]["value"] == line["attempted"] > 0
    assert line["failed"] == 0


def test_metrics_are_chosen_by_cell(toy_root):
    cell = bench.load_cell(toy_root, "toy_distill")
    assert {m["name"] for m in cell.end_to_end} == {
        "outer_steps_per_s", "peak_mem_gib", "setup_s", "toy_units"}
    assert cell.per_layer == []
    real = bench.load_cell(ROOT, "ucf_eval_vmap")
    assert {m["name"] for m in real.per_layer} == {
        "step.mfu.eval", "net.conv_ms.eval", "kernels_roofline.eval",
        "device.idle.eval"}


def test_every_metric_and_traffic_has_its_file():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(bench.reader(ROOT, m["name"]))
    for w in b["workloads"]:
        cell = bench.load_cell(ROOT, w["name"])
        assert set(cell.limits)
        assert callable(bench.loop(ROOT, cell.traffic["loop"]).run)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, line = bench.run_cell(ROOT, bench.parse(
        ["--workload", "ucf_s2d_mtt", "--seed", "1", "--seconds", "1"]), 0.0)
    assert rc != 0 and line is None
