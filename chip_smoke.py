"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build   — compile every CUDA source of the port with nvcc (in parallel).
2. check   — each hallucinator kernel against its plain PyTorch version on
             the card: fp32 at a small shape (B=4, F=8, 32x32; max error
             <= 1e-5 of the output's largest |value|) and bf16 at the S2D-MTT
             shape (B=500, F=16, 112x112) against the plain version computed
             in fp32 from the same bf16 inputs (every element within one bf16
             ulp, 2^-7 relative, plus 1e-5 of the largest |value| for the
             fp32 summation order); the fp32 weight gradient at 1e-3 of its
             largest |value|. Times kernel, plain version and the cuDNN
             convolution that computes the same function.
3. parity  — one fp32 S2D-MTT step at a small shape (3 classes, 64x64x8,
             syn_steps=2) on the card and on the CPU from the same inputs,
             draws and dropout masks: grand loss within 1e-5 relative,
             outer gradients within 1e-3 relative norm.
4. slice   — the S2D-MTT driver (``drivers.distill_s2d.run``) at full width
             (ConvNet3D 64/128/128, 50 classes, 112x112x16, syn_steps=10,
             bf16 with an fp32 head) from a fabricated expert buffer:
             1 warm-up + 3 timed outer steps, then one fp32 step. Loss and
             every outer gradient must be finite, syn_lr >= 0.001, and each
             kernel launched exactly once per outer step.

Then the ``kernels`` line (launch counts from the bf16 slice run), the
card's name and power limit, and the ``ok`` line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: CUDA is not available; this script needs a GPU")

from video_distillation_torch.config import get_preset  # noqa: E402
from video_distillation_torch.distill.mtt import (  # noqa: E402
    S2DHyper, S2DMTTStep, TrajectoryBuffer, flat_param_template)
from video_distillation_torch.distill.s2d import (  # noqa: E402
    S2DConfig, init_s2d_momentum, init_s2d_state)
from video_distillation_torch.drivers.common import load_data  # noqa: E402
from video_distillation_torch.drivers.distill_s2d import run  # noqa: E402
from video_distillation_torch.models.hallucinator import \
    init_hallucinator  # noqa: E402
from video_distillation_torch.ops import build, hal_conv as hc  # noqa: E402
from video_distillation_torch.utils.device import use_exact_fp32  # noqa: E402
from video_distillation_torch.utils.logging import MetricLogger  # noqa: E402

SOURCE = "video_distillation_torch/csrc/hal_conv.cu"
REPLACES = {"hal_fwd": "video_distillation_tpu/ops/pallas/hal_vjp.py:79",
            "hal_dgrad": "video_distillation_tpu/ops/pallas/hal_vjp.py:130",
            "hal_wgrad": "video_distillation_tpu/ops/pallas/hal_vjp.py:185"}
BF16_ULP = 2.0 ** -7
SLICE = dict(num_classes=50, frames=16, im=112, syn_steps=10)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s outside the tensor cores) from NVIDIA's data
    sheets for the H100 part the name gives."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12  # SXM


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(b, f, h, w, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    hal = init_hallucinator("concat", g, "cuda")
    return (mk(b, h, w, 3), mk(b, f, h, w, 1), hal["weight"].to(dtype),
            hal["bias"].to(dtype), mk(b, 3, f, h, w))


def max_err(out, ref):
    return float((out.float() - ref.float()).abs().max())


def check_max(name, out, ref, rel):
    """max |out - ref| <= rel * max |ref|."""
    err, scale = max_err(out, ref), float(ref.float().abs().max())
    if not err <= rel * scale:
        raise AssertionError(f"{name}: max error {err} > {rel} * {scale}")
    return err


def check_bf16(name, out, ref):
    """Every element within one bf16 ulp of the fp32 value, plus 1e-5 of the
    largest |value| for the summation order."""
    o, r = out.float(), ref.float()
    bound = BF16_ULP * r.abs() + 1e-5 * float(r.abs().max())
    worst = float(((o - r).abs() - bound).max())
    if not worst <= 0:
        raise AssertionError(f"{name}: bf16 result off by {worst} beyond "
                             "one ulp")
    return max_err(o, r)


def phase_build():
    t0 = time.perf_counter()
    secs = build.build_all()
    log = build.build_log("hal_conv").splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": secs, "ptxas": ptxas})


def phase_check():
    """Correctness at both shapes, then times at the slice's shape."""
    small = (4, 8, 32, 32)
    st, dy, wt, bs, g = inputs(*small, torch.float32, 0)
    errs = {}
    errs["hal_fwd"] = check_max("hal_fwd fp32", hc.hal_fwd(st, dy, wt, bs),
                                hc.hal_fwd_plain(st, dy, wt, bs), 1e-5)
    for need_s, need_d in ((True, True), (True, False), (False, True)):
        ds, dd = hc.hal_dgrad(g, wt, need_s, need_d)
        rs, rd = hc.hal_dgrad_plain(g, wt)
        if need_s:
            check_max(f"hal_dgrad ds fp32 {need_s, need_d}", ds, rs, 1e-5)
        else:
            assert ds is None
        if need_d:
            check_max(f"hal_dgrad dd fp32 {need_s, need_d}", dd, rd, 1e-5)
        else:
            assert dd is None
    dk, db = hc.hal_wgrad(g, st, dy)
    rk, rb = hc.hal_wgrad_plain(g, st, dy)
    check_max("hal_wgrad dk fp32", dk, rk, 1e-5)
    check_max("hal_wgrad db fp32", db, rb, 1e-5)
    emit({"phase": "check_fp32", "shape": small, "ok": True})

    b, f, h, w = SLICE["num_classes"] * SLICE["syn_steps"], SLICE["frames"], \
        SLICE["im"], SLICE["im"]
    st, dy, wt, bs, g = inputs(b, f, h, w, torch.bfloat16, 1)
    f32 = lambda *ts: [t.float() for t in ts]
    res = {}
    y = hc.hal_fwd(st, dy, wt, bs)
    res["hal_fwd"] = check_bf16("hal_fwd bf16", y,
                                hc.hal_fwd_plain(*f32(st, dy, wt, bs)))
    del y
    gf, wf = f32(g, wt)
    rs, rd = hc.hal_dgrad_plain(gf, wf)
    ds, dd = hc.hal_dgrad(g, wt, True, True)
    check_bf16("hal_dgrad ds bf16", ds, rs)
    check_bf16("hal_dgrad dd bf16", dd, rd)
    _, dd = hc.hal_dgrad(g, wt, False, True)
    res["hal_dgrad"] = check_bf16("hal_dgrad dd bf16 (dd only)", dd, rd)
    del ds, dd, rs, rd, gf
    dk, db = hc.hal_wgrad(g, st, dy)
    rk, rb = hc.hal_wgrad_plain(g, st, dy)
    res["hal_wgrad"] = max(check_max("hal_wgrad dk bf16", dk, rk, 1e-3),
                           check_max("hal_wgrad db bf16", db, rb, 1e-3))
    emit({"phase": "check_bf16", "shape": (b, f, h, w),
          "max_abs_err": res, "ok": True})

    # times at the slice's shape; the library call is cuDNN's conv3d and its
    # two backward halves on the materialised [static | dynamic] input
    x4 = torch.cat([st.permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, f, h, w),
                    dy.permute(0, 4, 1, 2, 3)], dim=1).contiguous()
    ms = {
        "hal_fwd": (lambda: hc.hal_fwd(st, dy, wt, bs),
                    lambda: hc.hal_fwd_plain(st, dy, wt, bs),
                    lambda: torch.nn.functional.conv3d(x4, wt, bs, padding=1)),
        "hal_dgrad": (lambda: hc.hal_dgrad(g, wt, False, True),
                      lambda: hc.hal_dgrad_plain(g, wt, False, True),
                      lambda: torch.nn.grad.conv3d_input(x4.shape, wt, g,
                                                         padding=1)),
        "hal_wgrad": (lambda: hc.hal_wgrad(g, st, dy),
                      lambda: hc.hal_wgrad_plain(g, st, dy),
                      lambda: torch.nn.grad.conv3d_weight(x4, wt.shape, g,
                                                          padding=1)),
    }
    bw, peak = card_peaks(torch.cuda.get_device_name(0))
    hw, e = h * w, 2  # bf16 bytes
    work = {  # (bytes moved, fp32 FLOPs) at this call's shapes
        "hal_fwd": (e * b * hw * (3 + f + 3 * f),
                    b * hw * (f * 2 * 81 + 2 * 243 + 3 * f)),
        "hal_dgrad": (e * b * hw * (3 * f + f), b * f * hw * 2 * 81),
        "hal_wgrad": (e * b * hw * (3 * f + 3 + f) + 4 * 327,
                      b * hw * (f * 2 * 81 + 2 * 243 + 6 * f)),
    }
    rows = {}
    for name, (kern, plain, lib) in ms.items():
        nbytes, flops = work[name]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": res[name], "ms": cuda_ms(kern, 10),
            "plain_ms": cuda_ms(plain, 3), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib, 5)}
    emit({"phase": "times", "rows": list(rows.values())})
    return rows


def phase_parity():
    """One small fp32 S2D-MTT step, kernels on the card vs the plain
    version on the CPU, from the same inputs, draws and dropout masks."""
    nc, f, im, steps = 3, 8, 64, 2
    cfg = S2DConfig(num_classes=nc, frames=f, im_size=(im, im))
    hyper = S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True)
    gen = torch.Generator().manual_seed(0)
    state = init_s2d_state(gen, cfg, "cpu")
    _, t0 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator().manual_seed(1), "cpu")
    _, t1 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator().manual_seed(2), "cpu")
    plan = torch.stack([torch.randperm(nc, generator=gen)
                        for _ in range(steps)]).int()
    draws = torch.randint(0, 2, (2, steps, nc), generator=gen)
    masks = torch.rand(steps, nc, 1, 1, 1, 128, generator=gen) < 0.5
    outs = {}
    for dev in ("cpu", "cuda"):
        mv = lambda t: t.to(dev)
        st = {"static": mv(state["static"]), "dynamic": mv(state["dynamic"]),
              "hals": [{k: mv(v) for k, v in p.items()}
                       for p in state["hals"]]}
        step = S2DMTTStep("ConvNet3D", 3, nc, (im, im), f, steps, cfg, hyper,
                          "float32", dev)
        outs[dev] = step(None, st, torch.tensor(0.01, device=dev),
                         init_s2d_momentum(st), torch.zeros((), device=dev),
                         mv(t0), mv(t1), mv(plan), draws=mv(draws),
                         keep_masks=mv(masks))
    ref, got = outs["cpu"], outs["cuda"]
    loss_rel = abs(float(got[4]) - float(ref[4])) / abs(float(ref[4]))
    assert loss_rel <= 1e-5, f"parity: grand loss off by {loss_rel}"
    grads = {"dynamic": (got[7]["dynamic"], ref[7]["dynamic"]),
             "syn_lr": (got[7]["syn_lr"], ref[7]["syn_lr"])}
    for k in ("weight", "bias"):
        grads[f"hal.{k}"] = (got[7]["hals"][0][k], ref[7]["hals"][0][k])
    rel = {}
    for k, (a, r) in grads.items():
        rel[k] = float((a.cpu() - r).norm() / r.norm())
        assert rel[k] <= 1e-3, f"parity: grad {k} off by {rel[k]} (rel norm)"
    emit({"phase": "parity", "loss_rel_err": loss_rel,
          "grad_rel_norm_err": rel, "ok": True})


def _finite(t):
    return bool(torch.isfinite(t).all())


def phase_slice(tmp):
    nc, f, im = SLICE["num_classes"], SLICE["frames"], SLICE["im"]
    _, t0 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator(device="cuda").manual_seed(0),
                                "cuda")
    _, t1 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator(device="cuda").manual_seed(1),
                                "cuda")
    TrajectoryBuffer(np.stack([t0.cpu().numpy(), t1.cpu().numpy()])[None]).save(
        os.path.join(tmp, "replay_buffer_0.npz"))

    def config(dtype, iterations):
        cfg = get_preset("s2d_MTT_ms")
        cfg.s2d = True
        cfg.dataset = f"synthetic_c{nc}_n1_t1_f{f}_im{im}"
        cfg.buffer_path = cfg.save_path = tmp
        cfg.Iteration, cfg.max_start_epoch = iterations, 1
        cfg.syn_steps, cfg.compute_dtype, cfg.device = \
            SLICE["syn_steps"], dtype, "cuda"
        return cfg

    cfg = config("bfloat16", 3)
    data = load_data(cfg)
    logger = MetricLogger(quiet=True)
    marks, losses = [], []

    def hook(it, out):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss, grads = out[4], out[7]
        losses.append(float(loss))
        named = {"loss": loss, "dynamic": grads["dynamic"],
                 "syn_lr": grads["syn_lr"]}
        for i, p in enumerate(grads["hals"]):
            named.update({f"hal{i}.{k}": v for k, v in p.items()})
        bad = [k for k, v in named.items() if not _finite(v)]
        if bad:
            raise AssertionError(f"step {it}: non-finite {bad}")
        if not float(out[1]) >= 0.001:
            raise AssertionError(f"step {it}: syn_lr {float(out[1])} < 0.001")
        for k, n in hc.LAUNCHES.items():
            if n != it + 1:
                raise AssertionError(f"step {it}: {k} launched {n} times "
                                     f"after {it + 1} outer steps")

    torch.cuda.reset_peak_memory_stats()
    hc.reset_launches()
    run(cfg, data, logger, step_hook=hook)
    launches = dict(hc.LAUNCHES)
    steps = cfg.Iteration + 1
    for k, n in launches.items():
        assert n == steps, f"{k}: {n} launches in {steps} outer steps"
    timed = len(marks) - 1
    emit({"phase": "slice", "compute_dtype": "bfloat16", "outer_steps": steps,
          "steps_per_sec": timed / (marks[-1] - marks[0]),
          "step_seconds": np.diff(marks).tolist(), "grand_loss": losses,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches})

    cfg = config("float32", 0)
    marks.clear()
    losses.clear()
    torch.cuda.reset_peak_memory_stats()
    hc.reset_launches()
    t_start = time.perf_counter()
    run(cfg, data, logger, step_hook=hook)
    emit({"phase": "slice", "compute_dtype": "float32", "outer_steps": 1,
          "seconds_with_setup": marks[0] - t_start, "grand_loss": losses,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def main():
    use_exact_fp32()
    phase_build()
    rows = phase_check()
    phase_parity()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_slice(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, row in rows.items():
        row["launches"] = launches[name]
    emit({"kernels": list(rows.values())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
