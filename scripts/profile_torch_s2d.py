"""Where the device time of one S2D-MTT outer step of the PyTorch port goes.

    python3 scripts/profile_torch_s2d.py [--dtype bfloat16] [--trace out.json]

Runs ``S2DMTTStep`` at the slice's full width (ConvNet3D 64/128/128,
50 classes, 112x112x16, syn_steps=10, frozen static, learnable syn_lr) on
one CUDA card: two warm-up outer steps, then ``--steps`` outer steps under
``torch.profiler``. Prints one JSON line: host wall time per step, the sum
of device activity per step and its share of the wall time, device time by
kernel family, the top kernels by device time, and the device time of
each convolution call site by its input shapes. ``--trace`` also writes
the Chrome trace of the profiled steps.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_distillation_torch.distill.mtt import (  # noqa: E402
    S2DHyper, S2DMTTStep, flat_param_template, make_batch_plan)
from video_distillation_torch.distill.s2d import (  # noqa: E402
    S2DConfig, init_s2d_momentum, init_s2d_state)
from video_distillation_torch.utils.device import (  # noqa: E402
    resolve_device, use_exact_fp32)

# first match wins; cuDNN and cuBLAS kernel names vary by version
FAMILIES = (
    ("hal_conv kernels", r"^hal_|hal_(fwd|dgrad|wgrad)"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"conv|xmma|implicit|cutlass|gemm|sm90|sm80|dgrad|wgrad|winograd|fft|cudnn"),
    ("pooling", r"pool"),
    ("reductions", r"reduce|Reduce|softmax|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|fill|copy"),
    ("memcpy / memset", r"Memcpy|Memset"),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


def device_us(evt, self_only=True) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for attr in names:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def conv_ops(prof, steps):
    """Device time of each convolution call site, by op and input shapes:
    which layer and which pass the convolution kernels serve."""
    rows = []
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.device_type != torch.autograd.DeviceType.CPU or evt.key not in (
                "aten::convolution", "aten::convolution_backward"):
            continue
        us = device_us(evt, self_only=False)
        if us > 0:
            rows.append({"op": evt.key, "input_shapes": str(evt.input_shapes)[:160],
                         "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": evt.count / steps})
    return sorted(rows, key=lambda r: -r["ms_per_step"])[:16]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    use_exact_fp32()
    nc, f, im, syn_steps = 50, 16, (112, 112), 10
    cfg = S2DConfig(num_classes=nc, frames=f, im_size=im)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_s2d_state(gen, cfg, dev)
    _, t0 = flat_param_template("ConvNet3D", 3, nc, im, f, gen, dev)
    _, t1 = flat_param_template("ConvNet3D", 3, nc, im, f, gen, dev)
    step = S2DMTTStep("ConvNet3D", 3, nc, im, f, syn_steps, cfg,
                      S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True),
                      args.dtype, dev)
    rng = np.random.default_rng(0)
    carry = [state, torch.tensor(0.01, device=dev), init_s2d_momentum(state),
             torch.zeros((), device=dev)]

    def one(it):
        plan = torch.as_tensor(make_batch_plan(rng, nc, nc, syn_steps),
                               device=dev)
        out = step(torch.Generator(device=dev).manual_seed(it), *carry, t0,
                   t1, plan)
        carry[:] = out[:4]
        return out[4]

    for it in range(2):
        float(one(it))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t_start = time.perf_counter()
        for it in range(args.steps):
            loss = one(2 + it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_start) / args.steps
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite grand loss {float(loss)}")

    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(evt.key, [0.0, 0])
        k[0] += us / 1e3 / args.steps
        k[1] += evt.count / args.steps
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(ms for ms, _ in kernels.values())
    fams = {}
    for name, (ms, _) in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "compute_dtype": args.dtype, "profiled_steps": args.steps,
        "wall_ms_per_step": wall * 1e3, "device_ms_per_step": busy,
        "device_busy_share": busy / (wall * 1e3),
        "family_ms_per_step": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
        "conv_call_sites": conv_ops(prof, args.steps),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }), flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
