"""Where the device time of one S2D-MTT outer step, of one evaluation
training step, of one static-learning (DC) step or of one DM step of the
PyTorch port goes.

    python3 scripts/profile_torch_s2d.py [--dtype bfloat16] [--trace out.json]
    python3 scripts/profile_torch_s2d.py --phase eval --steps 5
    python3 scripts/profile_torch_s2d.py --phase match   # or --phase inner
    python3 scripts/profile_torch_s2d.py --phase dm      # or --phase s2d_dm

``--phase distill`` (the default) runs ``S2DMTTStep`` at the slice's full
width (ConvNet3D 64/128/128, 50 classes, 112x112x16, syn_steps=10, frozen
static, learnable syn_lr) on one CUDA card: two warm-up outer steps, then
``--steps`` outer steps under ``torch.profiler``. ``--phase eval`` runs the
multi-static evaluation's training (``distill.evaluate.train_synset``, fp32,
all 50 synthetic videos in one batch) from a random S2D state at the same
width: a 2-step warm-up run, then a run of ``--steps`` steps (one per
epoch) under the profiler. Prints one JSON line: host wall time per step,
the sum of device activity per step and its share of the wall time, device
time by kernel family, the top kernels by device time, each of the port's
own kernels by name (time and calls per step), the device time
of each convolution call site by its input shapes, the fused first stage's
share (its five kernels plus its 2-D convolutions), and the cuDNN kernels
of the first stage's GEMM (forward, dgrad, wgrad) profiled alone at the
step's shape. ``--phase match`` and ``--phase inner`` profile static
learning at the ``static`` phase's width of ``chip_smoke.py`` (ConvNet
128/3, instance norm, 50 classes, 112x112, spc=10, fp32): ``--steps``
gradient-matching steps (``DCTrainer.match_step``, batch_real=64, random
uint8 real images), or ``--steps`` SGD steps of ``DCTrainer.inner_train``
on the 500 synthetic images, after one warm-up; they have no first stage,
so the first-stage fields are null. ``--phase dm`` and ``--phase s2d_dm``
profile ``--steps`` DM steps (``distill.dm.DMTrainer``, the DM preset's
raw tensor, or ``S2DDMTrainer``, ``s2d_DM_ms``: frozen static, fp32
compose) at the ``baselines`` phase's width of ``chip_smoke.py``
(ConvNet3D, 50 classes, 112x112x16, batch_real=64 random uint8 clips a
class, fp32 unless ``--dtype`` says otherwise) after one warm-up step;
``ranges_ms_per_step`` gives the real-clip embed's device time
(``dm_real_embed``), the rest of the step being the synthetic embed, its
backward and the update. ``--trace`` also writes the Chrome trace of the
profiled steps.
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

from video_distillation_torch.data.meta import (  # noqa: E402
    IMAGENET_MEAN, IMAGENET_STD, DatasetMeta)
from video_distillation_torch.data.store import ClipStore  # noqa: E402
from video_distillation_torch.distill import dc, dm  # noqa: E402
from video_distillation_torch.distill.evaluate import (  # noqa: E402
    EvalConfig, train_synset)
from video_distillation_torch.distill.mtt import (  # noqa: E402
    S2DHyper, S2DMTTStep, flat_param_template, make_batch_plan)
from video_distillation_torch.distill.s2d import (  # noqa: E402
    S2DConfig, init_s2d_momentum, init_s2d_state)
from video_distillation_torch.utils.device import (  # noqa: E402
    resolve_device, use_exact_fp32)

# first match wins; cuDNN and cuBLAS kernel names vary by version
FAMILIES = (
    ("hallucinator kernels", r"^hal_|hal_(fwd|dgrad|wgrad|fused)"),
    ("first-stage kernels", r"phase_(argmax|select|scatter)|s2d2_(un)?pack"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"conv|xmma|implicit|cutlass|gemm|sm90|sm80|dgrad|wgrad|winograd|fft|cudnn"),
    ("pooling", r"pool"),
    ("reductions", r"reduce|Reduce|softmax|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise|fill|copy"),
    ("memcpy / memset", r"Memcpy|Memset"),
)


# the profiler range around a DM step's real-clip embed
REAL_EMBED = "dm_real_embed"


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
    which layer and which pass the convolution kernels serve. ConvNet3D's
    only 2-D convolutions (input rank 4) are its fused first stage's."""
    rows = []
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.device_type != torch.autograd.DeviceType.CPU or evt.key not in (
                "aten::convolution", "aten::convolution_backward"):
            continue
        us = device_us(evt, self_only=False)
        if us > 0:
            rows.append({"op": evt.key, "input_shapes": str(evt.input_shapes)[:160],
                         "input_rank": len(evt.input_shapes[0])
                         if evt.input_shapes else None,
                         "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": evt.count / steps})
    return sorted(rows, key=lambda r: -r["ms_per_step"])


def first_stage_conv_kernels(dtype, batch, frames, im):
    """The cuDNN kernels of the fused first stage's GEMM (one stride-2 5x5
    conv over the packed (B*F, 36, H/2+4, W/2+4) channels-last input to
    256 channels) at the step's shape: device ms and kernels of its
    forward, its input gradient (dgrad) and its weight gradient (wgrad),
    each profiled alone."""
    dev = "cuda"
    hc = im // 2 + 4
    x = torch.randn(batch * frames, 36, hc, hc, device=dev, dtype=dtype,
                    ).contiguous(memory_format=torch.channels_last)
    w = torch.randn(256, 36, 5, 5, device=dev, dtype=dtype,
                    ).contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.conv2d(x, w, stride=2)
    gy = torch.randn_like(y)
    passes = {
        "forward": lambda: torch.nn.functional.conv2d(x, w, stride=2),
        "dgrad": lambda: torch.ops.aten.convolution_backward(
            gy, x, w, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
            [True, False, False]),
        "wgrad": lambda: torch.ops.aten.convolution_backward(
            gy, x, w, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
            [False, True, False]),
    }
    out = {}
    for name, fn in passes.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        out[name] = [{"name": evt.key[:140], "ms_per_call": device_us(evt) / 3e3}
                     for evt in prof.key_averages()
                     if evt.device_type == torch.autograd.DeviceType.CUDA
                     and device_us(evt) > 0]
    return {"input": list(x.shape), "weight": list(w.shape),
            "output": list(y.shape), "dtype": str(dtype), "passes": out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", default="distill",
                   choices=("distill", "eval", "match", "inner", "dm",
                            "s2d_dm"))
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                   help="the compute dtype: distill's default bfloat16, "
                        "dm's and s2d_dm's float32 (their presets'); eval, "
                        "match and inner are fp32")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)
    dm_phase = args.phase in ("dm", "s2d_dm")
    args.dtype = args.dtype or ("float32" if dm_phase else "bfloat16")

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
        return float(out[4])

    meta = DatasetMeta(name="profile", channel=3, im_size=im, num_classes=nc,
                       mean=IMAGENET_MEAN, std=IMAGENET_STD, frames=f)

    def evaluation(steps):
        ecfg = EvalConfig(epoch_eval_train=steps - 1, mode="multi-static")
        theta, _, _ = train_synset(gen, None, None, meta, ecfg, cfg, state)
        return float(theta.norm())

    def static_learning(phase, spc=10, batch_real=64):
        """(work, warm-up) for a DC matching step or inner SGD steps."""
        dmeta = DatasetMeta(name="profile_static", channel=3, im_size=im,
                            num_classes=nc, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD, frames=1)
        clips = rng.integers(0, 256, (nc * batch_real, *im, 3), np.uint8)
        store = ClipStore(clips, np.repeat(np.arange(nc), batch_real), dmeta)
        tr = dc.make_dc_trainer(store, "ConvNet", spc, batch_real, 0.1, 0.01,
                                device=dev)
        params = tr.fresh_net(gen)
        syn = torch.randn((nc * spc, *im, 3), generator=gen, device=dev)
        if phase == "match":
            mom = torch.zeros_like(syn)
            idx = torch.as_tensor(store.sample_per_class(rng, batch_real),
                                  device=dev)
            run = lambda n: float([tr.match_step(params, syn, mom, idx)  # noqa: E731
                                   for _ in range(n)][-1][2])
            return run, lambda: run(1)
        labels = torch.arange(nc, device=dev).repeat_interleave(spc)

        def run(n):
            tr.inner_loop = n
            zeros = {k: torch.zeros_like(v) for k, v in params.items()}
            p, _ = tr.inner_train(params, zeros, syn, labels)
            return float(p["head.weight"].norm())
        return run, lambda: run(1)

    def distribution_matching(s2d, batch_real=64):
        """(work, warm-up) for DM steps on random uint8 real clips."""
        dmeta = DatasetMeta(name="profile_dm", channel=3, im_size=im,
                            num_classes=nc, mean=IMAGENET_MEAN,
                            std=IMAGENET_STD, frames=f)
        clips = rng.integers(0, 256, (nc * batch_real, f, *im, 3), np.uint8)
        store = ClipStore(clips, np.repeat(np.arange(nc), batch_real), dmeta)
        if s2d:
            tr = dm.make_s2d_dm_trainer(store, "ConvNet3D", cfg, batch_real,
                                        100.0, 0.01, 0.01, False, f,
                                        args.dtype, device=dev)
            carry = [state, init_s2d_momentum(state)]
        else:
            tr = dm.make_dm_trainer(store, "ConvNet3D", 1, batch_real, 1.0, f,
                                    args.dtype, device=dev)
            syn = torch.randn((nc, f, *im, 3), generator=gen, device=dev)
            carry = [dm.DMState(syn, torch.arange(nc, device=dev),
                                torch.zeros_like(syn))]
        real_feats = tr.real_feats

        def marked(*a):
            with torch.profiler.record_function(REAL_EMBED):
                return real_feats(*a)
        tr.real_feats = marked

        def dm_step(it):
            g = torch.Generator(device=dev).manual_seed(it)
            out = tr(g, *carry, rng)
            carry[:] = out[:-1]
            return float(out[-1])
        return (lambda n: [dm_step(1 + i) for i in range(n)][-1],
                lambda: dm_step(0))

    if args.phase == "distill":
        work = lambda: [one(2 + it) for it in range(args.steps)][-1]  # noqa: E731
        for it in range(2):
            one(it)
    elif args.phase == "eval":
        work = lambda: evaluation(args.steps)  # noqa: E731
        evaluation(2)
    else:
        run, warm_up = (distribution_matching(args.phase == "s2d_dm")
                        if dm_phase else static_learning(args.phase))
        work = lambda: run(args.steps)  # noqa: E731
        warm_up()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t_start = time.perf_counter()
        value = work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_start) / args.steps
    if not np.isfinite(value):
        raise AssertionError(f"non-finite result {value}")

    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        # a record_function range shows as a device event too: not a kernel
        if (us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key == REAL_EMBED):
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
    convs = conv_ops(prof, args.steps)
    first_kernels = fams.get("first-stage kernels", 0.0)
    first_convs = sum(r["ms_per_step"] for r in convs if r["input_rank"] == 4)
    staged = args.phase in ("distill", "eval") or dm_phase  # ConvNet3D
    ranges = {}
    for evt in prof.key_averages():  # the range's CPU and device events
        if evt.key == REAL_EMBED:
            ranges[evt.key] = max(ranges.get(evt.key, 0.0), device_us(
                evt, self_only=False) / 1e3 / args.steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "phase": args.phase,
        "compute_dtype": (args.dtype if args.phase == "distill" or dm_phase
                          else "float32"),
        "model": "ConvNet3D" if staged else "ConvNet",
        "profiled_steps": args.steps,
        "wall_ms_per_step": wall * 1e3, "device_ms_per_step": busy,
        "device_busy_share": busy / (wall * 1e3),
        "family_ms_per_step": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
        # the port's own kernels, each by name, wherever they rank
        "port_kernels": [{"name": n[:120], "ms_per_step": ms,
                          "calls_per_step": c}
                         for n, (ms, c) in sorted(kernels.items())
                         if family(n) in ("hallucinator kernels",
                                          "first-stage kernels")],
        "conv_call_sites": convs[:16],
        "first_stage_ms_per_step": {
            "kernels": first_kernels, "convolutions_2d": first_convs,
            "total": first_kernels + first_convs} if staged else None,
        "first_stage_gemm": first_stage_conv_kernels(
            torch.bfloat16 if args.phase == "distill" and args.dtype == "bfloat16"
            else torch.float32, nc, f, im[0])
        if args.phase in ("distill", "eval") else None,
        "ranges_ms_per_step": ranges or None,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }), flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
