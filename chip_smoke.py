"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build   — compile every CUDA source of the port with nvcc (in parallel);
             ptxas's registers and spill bytes for each kernel.
2. check   — each hallucinator kernel against its plain PyTorch version on
             the card: fp32 at a small shape (B=4, F=8, 32x32; max error
             <= 1e-5 of the output's largest |value|; ``hal_fwd`` also on
             inputs one element past a 16-byte boundary, B=2, F=3, 17x112,
             in fp32 and in bf16) and bf16 at the S2D-MTT
             shape (B=500, F=16, 112x112) against the plain version computed
             in fp32 from the same bf16 inputs (every element within one bf16
             ulp, 2^-7 relative, plus 1e-5 of the largest |value| for the
             fp32 summation order); the fp32 weight gradient at 1e-3 of its
             largest |value|, and bit-equal across two calls. Times kernel,
             plain version and the cuDNN convolution that computes the same
             function (``hal_dgrad`` dd only, as the slice runs it, and
             with ds beside it); the bound takes the bf16 products at the tensor
             cores' rate and reports the FFMA time beside it. Then the three
             in fp32 at S2D-DM's shape (B=50, F=16, 112x112): forward and
             dgrad (dd only) within 1e-5, the weight gradient within 1e-5
             of the plain version computed in fp64 (with the fp32 plain
             version's, cuDNN's TF32 and the kernel's on bf16 inputs
             distances from fp64 beside it) and bit-equal across two
             calls; each timed beside its byte bound and cuDNN's conv3d.
2b. check_vmap — each kernel Function's ``torch.func.vmap`` rule: one
             vmapped call over 3 nets at the evaluation shape (fp32, B=50,
             F=16, 112x112) against the nets' unbatched calls, each kernel
             launched once a call: ``hal_fwd`` (static mapped and
             broadcast), ``hal_dgrad``, ``hal_fused`` (the nets folded by
             hand, as the batched evaluation composes), pack, unpack and
             the phase trio bit-equal; the weight gradient within 1e-5 of the
             largest |value| of fp64, summed over all nets' samples (grad
             outside vmap: one dgrad and one wgrad launch) and per net (vmap
             of grad); vmapped and loop times.
3. parity  — one fp32 S2D-MTT step at a small shape (3 classes, 64x64x8,
             syn_steps=2) on the card and on the CPU from the same inputs,
             draws and dropout masks: grand loss within 1e-5 relative,
             outer gradients within 1e-3 relative norm. Then the plain
             first stage (Conv3d + ReLU + MaxPool) in fp32 on both devices
             against an fp64 CPU step from the same draws: each device's
             outer gradients' relative-norm distance from fp64, the card's
             within 3x of the CPU's (or 1e-5).
4. slice   — the S2D-MTT driver (``drivers.distill_s2d.run``) at full width
             (ConvNet3D 64/128/128, 50 classes, 112x112x16, syn_steps=10,
             bf16 with an fp32 head) from a fabricated expert buffer:
             1 warm-up + 3 timed outer steps, then one fp32 step. Loss and
             every outer gradient must be finite, syn_lr >= 0.001, each
             hallucinator kernel launched exactly once per outer step, and
             per outer step pack, phase_argmax, phase_select and unpack
             syn_steps times and phase_scatter 2 x syn_steps times. Then
             the A/B of the first stage, through ``S2DMTTStep`` alone: 1
             warm-up + 3 timed bf16 steps with the fused stage and as many
             with ``fuse_first_stage=False``, steps/s and peak memory each.
5. check_first_stage — the five first-stage kernels (``ops.s2d2_move``:
             pack, unpack; ``ops.phase_trio``: argmax, select, scatter)
             against their plain versions: fp32 and bf16 at small shapes
             (the movers also at an odd packed width, at rows that are
             not a multiple of 16 bytes and at F = 9) and bf16 at the slice's
             inner-step shape (pack 50x16x112x112x3, the phase
             trio on the 627,200 x 256 GEMM output, m channel-planar), on
             random inputs and on inputs rounded so that phases tie. pack,
             unpack, the trio and the winner index must equal the plain
             versions bit for bit (unpack sums in fp32 in the plain
             version's order and rounds once). Each is timed there beside
             its plain version and, where one PyTorch call computes the same
             function, that call (``max`` over the phase axis, ``gather``,
             ``scatter_`` into zeros). pack is also checked and timed in
             fp32 at the evaluation shape (50x16x112x112x3), where it runs
             once per evaluation training step.
6. check_fused — the fused no-grad hallucinator kernel (``ops.hal_fused``)
             against its plain version and against ``hal_fwd``, fp32, at
             small shapes (B=4, F=8, 32x32; widths 13 and 113, which are
             not multiples of 4; F = 1 and 2; H = 1; a batch whose runs end
             inside a block) and at the evaluation shape B=50, F=16,
             112x112 (max error <= 1e-5 of the largest |value|; bit-equal
             across two calls), and timed there through its wrapper
             (``ms``) and alone through its C interface on weights
             flattened once (``kernel_ms``, 50 launches after warm-up),
             beside its plain version, cuDNN's conv3d and ``hal_fwd`` in
             fp32 on the same inputs (through its wrapper and alone).
7. pipeline — the paper's pipeline at full width (ConvNet3D 64/128/128, 50
             classes, 112x112x16, synthetic data): the buffer driver
             (``drivers.buffer``) trains 1 expert for 3 epochs in bf16;
             ``drivers.distill_s2d.run`` (``s2d_MTT_ms``, bf16) takes 3
             outer steps from that buffer and evaluates the multi-static
             set at iterations 0 and 2 with num_eval=2 fresh fp32 nets
             trained batched (``vmap_eval``, the default), the evaluation
             depth cut to epoch_eval_train=10 (the preset has 500). Every
             adjacent snapshot pair must differ, every accuracy be finite
             and in [0, 1], the artifacts and PNG grids exist, ``hal_fused``
             be launched once per batched evaluation training step (for
             all nets), and the first-stage kernels as often as the
             expert, distillation, batched evaluation-training and test
             batches need them. Then, on the distilled state, one
             evaluation point of 3 nets (10 + 1 epochs at B=50 and the test
             pass) batched and one net after the other, in the order
             batched, sequential, sequential, batched, each with its
             training and test seconds and peak memory; and one batched
             training step against each net's sequential step from the
             same draws: the change of θ within 1e-5 relative norm, or
             1e-2 where a phase max of the batched forward picked another
             winner (C.13).
7b. convert — the pipeline's expert buffer, ``hal_0.npz``,
             ``dynamic_0.npy`` and its static memory (as NHWC ``.npy``)
             through ``drivers.convert``'s CLI to the reference's ``.pt``
             and back, each byte-equal to its source (an npz member by
             member); then one S2D-MTT step from the static that went
             ``.npy`` -> ``.pt`` -> ``.npy``, which must stay as loaded.
8. expert  — one epoch of expert training (``distill.buffer.train_expert``)
             at full width and the preset's batch of 256 (two steps), in
             bf16 and in fp32 from the same parameters, batches, flips and
             dropout masks. The yardstick is bf16's own rounding: a third,
             fp32 epoch from the initial parameters rounded to bf16. The
             bf16 parameter change must be within 3x as far from the fp32
             one (relative norm) as that rounded epoch's is. Then a bf16
             step of 256 is timed, and the first-stage kernels counted
             (one pack, phase_argmax and phase_scatter a step, no unpack).

9. static  — static learning at full width: a synthetic miniUCF101-sized
             store (50 classes, 64 clips of 2 frames at 112x112) written
             with ``save_packed``, then ``drivers.distill_static.main``
             (load_packed -> single frames -> DC) with ConvNet, spc=10,
             batch_real=64, --Iteration 1 (two iterations, each 10 matching
             steps and 9 x 50 SGD steps on 500 images), fp32 with TF32
             off. The .npy must be (500, 112, 112, 3), finite and moved
             from its 'real' init, every loss finite; ms per matching step,
             ms per inner step, seconds per iteration and peak memory.
             Then one matching step and one inner_train at 3 classes,
             32x32, spc=10, from the same inputs, fp32 on the card and on
             the CPU against an fp64 CPU run: the card's loss, image
             update and trained parameters each within 3x (relative norm)
             of the CPU fp32 run's distance from fp64, or 1e-6. It
             launches none of the port's kernels.
10. baselines — the paper's baselines at full width (ConvNet3D, 50
             classes, 112x112x16) through their drivers, from one store of
             64 clips a class written with ``save_packed``: raw DM
             (``drivers.distill_baseline.main``, the DM preset, fp32: 1
             warm-up + 3 timed steps, then one bf16 step), S2D-DM
             (``drivers.distill_s2d.run``, ``s2d_DM_ms``, fp32 compose),
             raw MTT (the MTT preset from a fabricated two-snapshot buffer:
             1 warm-up + 3 timed bf16 steps, then one fp32 step) and
             k-center and herding (``drivers.distill_coreset.main``); the
             evaluations cut to one net of 10 epochs. Each step runs with
             the launch counts set to 0 just before it and checked just
             after: a DM step packs and takes the phase max once per real
             chunk of 320 clips and once for the synthetic set, scatters
             and unpacks once and never selects; S2D-DM adds one launch of
             each ``hal_conv`` kernel; raw MTT launches as an S2D-MTT outer
             step; a coreset selection packs and takes the phase max once
             per class. Losses and gradients finite, the learned sets moved,
             syn_lr >= 0.001, every chosen clip from its class, ``hal_fused``
             once per evaluation training step; ms per step (real embed and
             the rest), steps/s, ms per embed chunk, peak memory. A second
             S2D-DM run at lr_dynamic = lr_hal = 1e-4 (ROADMAP C.12), 10
             steps: the loss of a fixed probe net and real batch must fall.
             Then one raw DM, one S2D-DM and one raw MTT step at 3 classes,
             64x64x8, fp32, on the card against the CPU from the same
             inputs, net and draws: DM losses within 1e-5 relative,
             gradients and updates within 1e-4 (relative norm); raw MTT over
             9 draws, each against an fp64 CPU step: the loss within 1e-5
             card against CPU, and each fp32 device's outer gradients within
             1e-5 of fp64, or within 1e-2 where a max of that device's
             forward (the phase max, a later max-pool) picked another winner
             than the fp64 step's (ROADMAP C.13).
11. frepo  — FRePo at full width through ``drivers.distill_frepo.main`` on
             the baselines' store, with the driver's defaults (ConvNet3D,
             ppc=dpc=1, n_hal=1, 10 pool nets, 100 online updates,
             batch_real 512, lr_d 1e2), fp32: 3 iterations and one
             evaluation at the last (one net of 10 epochs; the driver: 3 of
             500). Each step runs with the launch counts set to 0 just before
             it and checked just after: pack and phase_argmax once per real
             chunk and twice more, phase_scatter twice, unpack once, select
             never, each ``hal_conv`` kernel and ``hal_fused`` once. The
             loss finite; the dynamic memory and the hallucinator moved, the
             static bit-equal to its initial value, one pool step an
             iteration; the KRR and NN accuracies in [0, 1]; the evaluation
             launches ``hal_fused`` once (``compose_eval``) and no other
             ``hal_*`` kernel. ms per step, the real embed's, the synthetic
             side's and the pool step's; the KRR and the NN evaluation's
             seconds; peak memory. Then one proto step and one pool step at
             3 classes, 64x64x8, fp32 on the card and on the CPU against an
             fp64 CPU step from the same inputs and draws: the loss and
             every gradient within 1e-4 of fp64, or within 1e-2 if a max
             picked another winner than fp64's.

12. zoo    — the VideoConvNets on the baselines' store (50 classes,
             112x112x16): VideoConvNetMean and VideoConvNetLSTM evaluated
             (3 nets batched, 3 epochs of one step on a one-clip-a-class raw
             set, 64x64 after the crop) with the batched test pass, and one
             raw DM step with VideoConvNetGRU through
             ``distill_baseline.main`` (real clips in chunks that keep its
             widest activation under 2^30 elements): finite parameters and
             loss, accuracies in [0, 1], none of the port's kernels
             launched; ms a step and peak memory.

13. images — the image side at CIFAR10's size (10 classes, 32x32x3,
             50,000 training and 10,000 test images made from a seed as
             class-mean colours plus noise, through ``from_arrays`` and
             ``save_packed``): ``drivers.distill_coreset.main`` with k-center
             on ConvNet at ipc 10 and the pool 'M' (MLP, ConvNet, LeNet,
             AlexNet, VGG11, ResNet18), each evaluation 3 nets batched
             (``distill_coreset`` runs them one after the other; the phase
             patches in ``vmap_eval=True``), 20 + 1 epochs (its default:
             1000), seconds per point scaled to its epochs, test-pass
             seconds, peak memory, every chosen image of its class; raw DM
             (``distill_baseline.main``, ConvNet, ipc 10, batch_real 256,
             1 + 3 fp32 steps on the (N, 1, H, W, C) set); raw FRePo
             (``s2d=False``, 3 steps); one training step of each pool-M net
             and of Conv and KIP_ConvNet, and the BatchNorm modules' train
             (with the running update) and eval forwards, fp32 on the card
             and on the CPU against fp64 (the card within 3x of the CPU's
             distance, or 1e-5, or 1e-2 where a max-pool flipped); ZCA
             fitted on the host on the 50,000 images, applied and inverted
             on the card (round trip within 1e-3). No kernel of the port
             launches in the phase.

Then the ``kernels`` line (launch counts: the three ``hal_conv`` and the
five first-stage kernels from the bf16 slice run, ``hal_fused`` from the
pipeline run's batched evaluations; the other paths' counts are in their
phases' lines), the
card's name and power limit, and the ``ok`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: CUDA is not available; this script needs a GPU")

from video_distillation_torch.config import BufferConfig, get_preset  # noqa: E402
from video_distillation_torch.data.image_datasets import \
    from_arrays  # noqa: E402
from video_distillation_torch.data.store import (  # noqa: E402
    load_packed, save_packed)
from video_distillation_torch.data.synthetic import (  # noqa: E402
    make_synthetic_video_data, synthetic_kwargs_from_name)
from video_distillation_torch.distill import (  # noqa: E402
    coreset, dc, dm, frepo)
from video_distillation_torch.distill.buffer import (  # noqa: E402
    ExpertDraws, train_expert)
from video_distillation_torch.distill import evaluate  # noqa: E402
from video_distillation_torch.distill.evaluate import (  # noqa: E402
    TEST_BATCH, EvalConfig, EvalDraws, evaluate_many, run_test_pass,
    sample_test_batches, train_synset, train_synsets)
from video_distillation_torch.distill.mtt import (  # noqa: E402
    MTTStep, S2DHyper, S2DMTTStep, TrajectoryBuffer, flat_param_template,
    make_batch_plan)
from video_distillation_torch.distill.s2d import (  # noqa: E402
    S2DConfig, init_s2d_momentum, init_s2d_state)
from video_distillation_torch.distill.dm import \
    init_synthetic_raw  # noqa: E402
from video_distillation_torch.drivers import buffer as buffer_driver  # noqa: E402
from video_distillation_torch.drivers import (  # noqa: E402
    convert, distill_baseline, distill_coreset, distill_frepo, distill_static)
from video_distillation_torch.drivers.common import load_data  # noqa: E402
from video_distillation_torch.drivers.distill_s2d import (  # noqa: E402
    build_s2d, run)
from video_distillation_torch.models import (  # noqa: E402
    classic, convnet3d, frepo_nets)
from video_distillation_torch.models.registry import \
    create_model  # noqa: E402
from video_distillation_torch.models.hallucinator import \
    init_hallucinator  # noqa: E402
from video_distillation_torch.ops import build, hal_conv as hc  # noqa: E402
from video_distillation_torch.ops import hal_fused as hf  # noqa: E402
from video_distillation_torch.ops import phase_trio as pt  # noqa: E402
from video_distillation_torch.ops import s2d2_move as sm  # noqa: E402
from video_distillation_torch.ops import zca  # noqa: E402
from video_distillation_torch.utils.device import (  # noqa: E402
    step_generator, use_exact_fp32)
from video_distillation_torch.utils.logging import MetricLogger  # noqa: E402

SOURCE = "video_distillation_torch/csrc/hal_conv.cu"
FUSED_SOURCE = "video_distillation_torch/csrc/hal_fused.cu"
REPLACES = {"hal_fwd": "video_distillation_tpu/ops/pallas/hal_vjp.py:79",
            "hal_dgrad": "video_distillation_tpu/ops/pallas/hal_vjp.py:130",
            "hal_wgrad": "video_distillation_tpu/ops/pallas/hal_vjp.py:185",
            "hal_fused":
                "video_distillation_tpu/ops/pallas/hallucinator_kernel.py:33",
            "phase_argmax": "video_distillation_tpu/ops/pallas/phase_trio.py:48",
            "phase_select": "video_distillation_tpu/ops/pallas/phase_trio.py:71",
            "phase_scatter": "video_distillation_tpu/ops/pallas/phase_trio.py:80",
            "s2d2_pack": "video_distillation_tpu/ops/pallas/s2d2_move.py:47",
            "s2d2_unpack": "video_distillation_tpu/ops/pallas/s2d2_move.py:73"}
FIRST_STAGE_SOURCES = {
    "phase_argmax": "video_distillation_torch/csrc/phase_trio.cu",
    "phase_select": "video_distillation_torch/csrc/phase_trio.cu",
    "phase_scatter": "video_distillation_torch/csrc/phase_trio.cu",
    "s2d2_pack": "video_distillation_torch/csrc/s2d2_move.cu",
    "s2d2_unpack": "video_distillation_torch/csrc/s2d2_move.cu"}
BF16_ULP = 2.0 ** -7
SLICE = dict(num_classes=50, frames=16, im=112, syn_steps=10)
# the evaluation's training batch: all 50 synthetic videos (spc=2, vpc=1)
EVAL_SHAPE = (50, 16, 112, 112)
PIPELINE = dict(dataset="synthetic_c50_n2_t2_f16_im112", expert_epochs=3,
                iterations=2, eval_it=2, num_eval=2, epoch_eval_train=10)
PAPER_EVAL = dict(epoch_eval_train=500, num_eval=3)  # the s2d_MTT_ms preset
# batched evaluation's nets: the presets' num_eval
VMAP_NETS = PAPER_EVAL["num_eval"]
# 300 train clips: two steps of the preset's batch_train=256 an epoch
EXPERT = dict(dataset="synthetic_c50_n6_t1_f16_im112", batch=256,
              timed_epochs=2)
# the bf16 epoch may stray from fp32 at most this many times as far as an
# fp32 epoch from bf16-rounded initial parameters does
EXPERT_BF16_FACTOR = 3.0
# static learning at full width: miniUCF101's 50 classes at 112x112, 64
# clips a class so batch_real=64 draws distinct ones, 2 frames a clip; the
# s2d_MTT_ms_5 preset's spc=10 (10 matching steps and 9 x 50 SGD steps on
# 500 images an iteration)
STATIC = dict(synthetic="synthetic_c50_n64_t1_f2_im112",
              dataset="staticsmoke_c50_n64_f2_im112", model="ConvNet",
              spc=10, batch_real=64, iteration=1, seed=0)
# the card against the CPU, one matching step and one inner_train: ConvNet
# (width 128) at 3 classes, 32x32, spc=10, batch_real=16
DC_SMALL = dict(num_classes=3, clips_per_class=16, frames=2, im_size=(32, 32),
                name="dc-card-vs-cpu")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 FLOP/s on
    the tensor cores) from NVIDIA's H100 data sheet for the part the name
    gives (the sheet's bf16 figures are with sparsity: half of each)."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12  # SXM


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


def check_equal(name, out, ref):
    """Bit-equal to the plain version (a kernel that copies values)."""
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: differs from the plain version, max "
                             f"error {max_err(out, ref)}")
    return 0.0


def check_wgrad_deterministic(name, dk, db, g, st, dy):
    """A second call on the same inputs gives the same bits."""
    dk2, db2 = hc.hal_wgrad(g, st, dy)
    if not (torch.equal(dk, dk2) and torch.equal(db, db2)):
        raise AssertionError(f"hal_wgrad {name}: two calls differ")


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def first_stage_launches():
    return {**pt.LAUNCHES, **sm.LAUNCHES}


def reset_first_stage():
    pt.reset_launches()
    sm.reset_launches()


def per_outer_step(syn_steps):
    """First-stage launches of one S2D-MTT outer step: each inner forward
    packs and takes the phase max; each inner backward scatters; the outer
    backward scatters through every forward, selects through every inner
    scatter and unpacks every pack's cotangent."""
    return {"phase_argmax": syn_steps, "phase_select": syn_steps,
            "phase_scatter": 2 * syn_steps, "s2d2_pack": syn_steps,
            "s2d2_unpack": syn_steps}


def first_order(steps, no_grad_forwards=0):
    """First-stage launches of ``steps`` first-order training steps (no
    input gradient, so no unpack) and ``no_grad_forwards`` forwards."""
    forwards = steps + no_grad_forwards
    return {"phase_argmax": forwards, "phase_select": 0,
            "phase_scatter": steps, "s2d2_pack": forwards, "s2d2_unpack": 0}


def check_first_stage_counts(where, want):
    got = first_stage_launches()
    if got != want:
        raise AssertionError(f"{where}: first-stage launches {got}, "
                             f"expected {want}")
    return got


def kernel_name(mangled):
    """``hal_wgrad_band_bf16_kernel`` or ``s2d2_pack_kernel<u16,3>`` from
    an Itanium-mangled name: the length-prefixed part that ends in
    ``_kernel``, and its leading template arguments."""
    types = {"I13__nv_bfloat16": "bf16", "If": "float", "It": "u16",
             "Ij": "u32"}
    i = 3  # past "_ZN": the nested names, each prefixed by its length
    while (m := re.match(r"\d+", mangled[i:])):
        n, i = int(m.group()), i + m.end()
        name, i = mangled[i:i + n], i + n
        if not name.endswith("_kernel"):
            continue
        tail, args = mangled[i:], []
        if (b := re.match(r"ILb(\d)E", tail)):  # one bool template argument
            return f"{name}<{b.group(1)}>"
        for code, short in types.items():
            if tail.startswith(code):
                args.append(short)
                c = re.match(r"L[ib](\d+)E", tail[len(code):])
                if c:
                    args.append(c.group(1))
        return f"{name}<{','.join(args)}>" if args else name
    return mangled


def ptxas_table(log):
    """Per kernel: ptxas's registers and spill bytes (stores + loads)."""
    rows = []
    for ln in log:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            rows.append({"kernel": kernel_name(m.group(1))})
        elif rows and "registers" in ln:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
        elif rows and "spill" in ln:
            rows[-1]["spill_bytes"] = sum(
                map(int, re.findall(r"(\d+) bytes spill", ln)))
    return rows


def phase_build():
    t0 = time.perf_counter()
    secs = build.build_all()
    log = "\n".join(build.build_log(n) for n in build.SOURCES).splitlines()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": secs, "ptxas": ptxas_table(log)})


def check_fwd_unaligned():
    """hal_fwd on a static and a dynamic one element past a 16-byte boundary
    (staged element by element), fp32 and bf16, at a width of 112."""
    b, f, h, w = 2, 3, 17, 112
    for dtype, seed in ((torch.float32, 11), (torch.bfloat16, 15)):
        st = randn((1 + b * h * w * 3,), dtype, seed)[1:].view(b, h, w, 3)
        dy = randn((1 + b * f * h * w,), dtype, seed + 1)[1:].view(b, f, h, w, 1)
        assert st.data_ptr() % 16 != 0 and dy.data_ptr() % 16 != 0
        wt = randn((3, 4, 3, 3, 3), dtype, seed + 2)
        bs = randn((3,), dtype, seed + 3)
        y = hc.hal_fwd(st, dy, wt, bs)
        ref = hc.hal_fwd_plain(st.float(), dy.float(), wt.float(), bs.float())
        if dtype == torch.float32:
            check_max("hal_fwd fp32 unaligned", y, ref, 1e-5)
        else:
            check_bf16("hal_fwd bf16 unaligned", y, ref)
    return (b, f, h, w)


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
    check_wgrad_deterministic("fp32", dk, db, g, st, dy)
    emit({"phase": "check_fp32", "shape": small,
          "hal_fwd_unaligned_shape": check_fwd_unaligned(), "ok": True})

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
    check_wgrad_deterministic("bf16", dk, db, g, st, dy)
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
    bw, ffma, tensor = card_peaks(torch.cuda.get_device_name(0))
    hw, e = h * w, 2  # bf16 bytes
    # (bytes moved, FLOPs) at this call's shapes; the bound takes the bf16
    # products at the tensor cores' rate, the least time the card could
    # take for them, and the FFMA time is reported beside it
    work = {
        "hal_fwd": (e * b * hw * (3 + f + 3 * f),
                    b * hw * (f * 2 * 81 + 2 * 243 + 3 * f)),
        "hal_dgrad": (e * b * hw * (3 * f + f), b * f * hw * 2 * 81),
        "hal_wgrad": (e * b * hw * (3 * f + 3 + f) + 4 * 327,
                      b * hw * (f * 2 * 81 + 2 * 243 + 6 * f)),
    }
    rows, ffma_ms = {}, {}
    for name, (kern, plain, lib) in ms.items():
        nbytes, flops = work[name]
        t_bytes, t_ops = nbytes / bw * 1e3, flops / tensor * 1e3
        ffma_ms[name] = flops / ffma * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": res[name], "ms": cuda_ms(kern, 10),
            "plain_ms": cuda_ms(plain, 3), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib, 5)}
    # hal_dgrad with the static cotangent too (off the main path, whose
    # static is frozen): ȳ read once, ds and dd written; the static's
    # stencils (729 FMAs a pixel) and Σ_t ȳ on top of dd's products
    nbytes = e * b * hw * (3 * f + f + 3)
    flops = b * f * hw * 2 * 81 + b * hw * (2 * 729 + 3 * f)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / tensor * 1e3
    ds_dd = {"ms": cuda_ms(lambda: hc.hal_dgrad(g, wt, True, True), 10),
             "plain_ms": cuda_ms(lambda: hc.hal_dgrad_plain(g, wt), 3),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit({"phase": "times", "rows": list(rows.values()),
          "ffma_bound_ms": ffma_ms, "hal_dgrad_ds_dd": ds_dd})
    check_hal_fp32_full_width()
    return rows


def hal_wgrad_fp64(g, static, dynamic):
    """(dweight, dbias) in fp64 from the same inputs: cuDNN's weight
    gradient on the materialised [static | dynamic] input."""
    b, _, f, h, w = g.shape
    x4 = torch.cat([static.double().permute(0, 3, 1, 2).unsqueeze(2)
                    .expand(b, 3, f, h, w),
                    dynamic.double().permute(0, 4, 1, 2, 3)], dim=1)
    g64 = g.double()
    return (torch.nn.grad.conv3d_weight(x4, (3, 4, 3, 3, 3), g64, padding=1),
            g64.sum((0, 2, 3, 4)))


def wgrad_rel_err(dk, db, rk, rb):
    """max |error| over the largest |value|, the worse of dk and db."""
    return max(max_err(dk, rk) / float(rk.abs().max()),
               max_err(db, rb) / float(rb.abs().max()))


def check_hal_fp32_full_width():
    """The three hal_conv kernels in fp32 at S2D-DM's shape (B = C x vpc =
    50, F=16, 112x112; S2D-DM composes in fp32), each within 1e-5 of the
    largest |value| of its plain version (the fp32 tolerance above): the
    forward and dd-only dgrad against the plain version in fp32, the
    weight gradient, whose taps each sum 10^7 products, against it in
    fp64, beside the fp32 plain version's, cuDNN's TF32 and the kernel's
    on bf16 inputs distances from fp64; the weight gradient bit-equal
    across two calls; each timed beside its byte bound and cuDNN's
    conv3d."""
    b, f, h, w = EVAL_SHAPE
    st, dy, wt, bs, g = inputs(b, f, h, w, torch.float32, 5)
    errs = {"hal_fwd": check_max("hal_fwd fp32 full width",
                                 hc.hal_fwd(st, dy, wt, bs),
                                 hc.hal_fwd_plain(st, dy, wt, bs), 1e-5)}
    _, dd = hc.hal_dgrad(g, wt, False, True)
    errs["hal_dgrad"] = check_max("hal_dgrad dd fp32 full width", dd,
                                  hc.hal_dgrad_plain(g, wt)[1], 1e-5)
    dk, db = hc.hal_wgrad(g, st, dy)
    rk, rb = hal_wgrad_fp64(g, st, dy)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = hc.hal_wgrad_plain(g, st, dy)
    bf16 = lambda t: t.to(torch.bfloat16)
    rel_to_fp64 = {
        "kernel": wgrad_rel_err(dk, db, rk, rb),
        "plain_fp32": wgrad_rel_err(*hc.hal_wgrad_plain(g, st, dy), rk, rb),
        "plain_tf32": wgrad_rel_err(*tf32, rk, rb),
        "kernel_bf16_inputs": wgrad_rel_err(
            *hc.hal_wgrad(bf16(g), bf16(st), bf16(dy)), rk, rb)}
    emit({"phase": "check_fp32_full_width_wgrad",
          "rel_err_to_fp64": rel_to_fp64})
    errs["hal_wgrad"] = max(check_max("hal_wgrad dk fp32 full width", dk, rk,
                                      1e-5),
                            check_max("hal_wgrad db fp32 full width", db, rb,
                                      1e-5))
    check_wgrad_deterministic("fp32 full width", dk, db, g, st, dy)
    x4 = torch.cat([st.permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, f, h, w),
                    dy.permute(0, 4, 1, 2, 3)], dim=1).contiguous()
    bw, ffma, _ = card_peaks(torch.cuda.get_device_name(0))
    hw, e = h * w, 4
    # (kernel, plain, cuDNN, bytes moved, fp32 FLOPs at the FFMA rate)
    ms = {
        "hal_fwd": (lambda: hc.hal_fwd(st, dy, wt, bs),
                    lambda: hc.hal_fwd_plain(st, dy, wt, bs),
                    lambda: torch.nn.functional.conv3d(x4, wt, bs, padding=1),
                    e * b * hw * (3 + f + 3 * f),
                    b * hw * (f * 2 * 81 + 2 * 243 + 3 * f)),
        "hal_dgrad": (lambda: hc.hal_dgrad(g, wt, False, True),
                      lambda: hc.hal_dgrad_plain(g, wt, False, True),
                      lambda: torch.nn.grad.conv3d_input(x4.shape, wt, g,
                                                         padding=1),
                      e * b * hw * (3 * f + f), b * f * hw * 2 * 81),
        "hal_wgrad": (lambda: hc.hal_wgrad(g, st, dy),
                      lambda: hc.hal_wgrad_plain(g, st, dy),
                      lambda: torch.nn.grad.conv3d_weight(x4, wt.shape, g,
                                                          padding=1),
                      e * b * hw * (3 * f + 3 + f) + e * 327,
                      b * hw * (f * 2 * 81 + 2 * 243 + 6 * f)),
    }
    rows = []
    for name, (kern, plain, lib, nbytes, flops) in ms.items():
        t_bytes, t_ops = nbytes / bw * 1e3, flops / ffma * 1e3
        rows.append({"name": name, "dtype": "float32", "shape": EVAL_SHAPE,
                     "max_abs_err": errs[name], "ms": cuda_ms(kern, 20),
                     "plain_ms": cuda_ms(plain, 3),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": cuda_ms(lib, 5)})
    emit({"phase": "check_fp32_full_width", "rows": rows, "ok": True})


def all_launches():
    """Every kernel's launch count that is not 0."""
    return {k: v for k, v in {**hc.LAUNCHES, **hf.LAUNCHES, **pt.LAUNCHES,
                              **sm.LAUNCHES}.items() if v}


def reset_all_launches():
    hc.reset_launches()
    hf.reset_launches()
    reset_first_stage()


def launched(fn):
    """(fn's output, the launches it made)."""
    reset_all_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, all_launches()


def check_vmap_rule(name, vmapped, loop, want, compare):
    """One vmapped call against the nets' unbatched calls: the launches it
    makes must be ``want`` and ``compare(batched, per_net)`` passes."""
    got, n = launched(vmapped)
    if n != want:
        raise AssertionError(f"vmap {name}: launches {n}, expected {want}")
    err = compare(got, loop())
    return {"name": name, "launches": n, "max_abs_err": err,
            "vmapped_ms": cuda_ms(vmapped, 3), "loop_ms": cuda_ms(loop, 3)}


def _equal_each(name):
    def compare(got, refs):
        got = got if isinstance(got, (tuple, list)) else (got,)
        for e, ref in enumerate(refs):
            ref = ref if isinstance(ref, (tuple, list)) else (ref,)
            for a, r in zip(got, ref):
                check_equal(f"vmap {name} net {e}", a[e], r)
        return 0.0
    return compare


def phase_check_vmap():
    """Each kernel Function's torch.func.vmap rule on the card: one vmapped
    call over VMAP_NETS nets at the evaluation shape (fp32, B=50,
    112x112x16) against the nets' unbatched calls, with the launches each
    makes: bit-equal for the kernels that compute per sample; the weight
    gradient, a sum over the folded samples, within 1e-5 of the largest
    |value| of an fp64 reference (over all nets' samples, grad outside vmap;
    per net, vmap of grad)."""
    from torch.func import grad, vmap
    E, (b, f, h, w) = VMAP_NETS, EVAL_SHAPE
    st, dy = randn((E, b, h, w, 3), torch.float32, 40), \
        randn((E, b, f, h, w, 1), torch.float32, 41)
    wt, bs = randn((3, 4, 3, 3, 3), torch.float32, 42) * 0.2, \
        randn((3,), torch.float32, 43)
    rows = [check_vmap_rule(
        "hal_fwd", lambda: vmap(hc.hal_conv, in_dims=(0, 0, None, None))(
            st, dy, wt, bs),
        lambda: [hc.hal_conv(st[e], dy[e], wt, bs) for e in range(E)],
        {"hal_fwd": 1}, _equal_each("hal_fwd"))]
    rows.append(check_vmap_rule(
        "hal_fwd_broadcast_static",
        lambda: vmap(hc.hal_conv, in_dims=(None, 0, None, None))(
            st[0], dy, wt, bs),
        lambda: [hc.hal_conv(st[0], dy[e], wt, bs) for e in range(E)],
        {"hal_fwd": 1}, _equal_each("hal_fwd_broadcast_static")))
    ybar = randn((E, b, f, h, w, 3), torch.float32, 44)
    planar = ybar.permute(0, 1, 5, 2, 3, 4).contiguous()  # (E, b, 3, f, h, w)
    rows.append(check_vmap_rule(
        "hal_dgrad", lambda: vmap(lambda g: hc.HalDgrad.apply(
            g, wt, False, True)[1])(planar),
        lambda: [hc.hal_dgrad(planar[e], wt, False, True)[1]
                 for e in range(E)],
        {"hal_dgrad": 1}, _equal_each("hal_dgrad")))

    def shared_grads():
        """grad outside vmap: the backward of the folded call."""
        d = dy.detach().requires_grad_(True)
        wq, bq = wt.detach().requires_grad_(True), bs.detach().requires_grad_(True)
        y = vmap(hc.hal_conv, in_dims=(0, 0, None, None))(st, d, wq, bq)
        return torch.autograd.grad(y, (d, wq, bq), ybar)

    (dd, dk, db), n = launched(shared_grads)
    want = {"hal_fwd": 1, "hal_dgrad": 1, "hal_wgrad": 1}
    if n != want:
        raise AssertionError(f"vmap hal_conv backward: launches {n}, "
                             f"expected {want}")
    for e in range(E):
        check_equal(f"vmap hal_conv backward dd net {e}", dd[e],
                    hc.hal_dgrad(planar[e], wt, False, True)[1])
    rk, rb = hal_wgrad_fp64(planar.flatten(0, 1), st.flatten(0, 1),
                            dy.flatten(0, 1))
    shared_err = max(check_max("vmap hal_wgrad dk (all nets)", dk, rk, 1e-5),
                     check_max("vmap hal_wgrad db (all nets)", db, rb, 1e-5))

    def per_net_loss(wq, bq, s, d, yb):
        return (hc.hal_conv(s, d, wq, bq) * yb).sum()

    per_net = lambda: vmap(grad(per_net_loss, argnums=(0, 1)),  # noqa: E731
                           in_dims=(None, None, 0, 0, 0))(wt, bs, st, dy, ybar)
    (pk, pb), n = launched(per_net)
    if n != {"hal_fwd": 1, "hal_wgrad": 1}:
        raise AssertionError(f"vmap of grad hal_wgrad: launches {n}")
    per_err = 0.0
    for e in range(E):
        rk, rb = hal_wgrad_fp64(planar[e], st[e], dy[e])
        per_err = max(per_err,
                      check_max(f"vmap hal_wgrad dk net {e}", pk[e], rk, 1e-5),
                      check_max(f"vmap hal_wgrad db net {e}", pb[e], rb, 1e-5))
    rows.append({"name": "hal_wgrad", "launches": {"hal_wgrad": 1},
                 "max_abs_err_all_nets": shared_err,
                 "max_abs_err_per_net": per_err,
                 "vmapped_ms": cuda_ms(shared_grads, 3),
                 "per_net_vmapped_ms": cuda_ms(per_net, 3)})
    del ybar, planar, dd, dk, db, pk, pb
    rows.append(check_vmap_rule(
        "hal_fused", lambda: hf.hal_fused(st.flatten(0, 1), dy.flatten(0, 1),
                                          wt, bs).unflatten(0, (E, b)),
        lambda: [hf.hal_fused(st[e], dy[e], wt, bs) for e in range(E)],
        {"hal_fused": 1}, _equal_each("hal_fused")))
    del st, dy

    x = randn((E, b, f, h, w, 3), torch.float32, 45)
    rows.append(check_vmap_rule(
        "s2d2_pack", lambda: vmap(sm.Pack.apply)(x),
        lambda: [sm.Pack.apply(x[e]) for e in range(E)],
        {"s2d2_pack": 1}, _equal_each("s2d2_pack")))
    hc_, wc_ = sm.packed_hw(h, w)
    del x
    gp = randn((E, b, f, hc_, wc_, 36), torch.float32, 46)
    rows.append(check_vmap_rule(
        "s2d2_unpack", lambda: vmap(lambda g: sm.Unpack.apply(g, h, w))(gp),
        lambda: [sm.Unpack.apply(gp[e], h, w) for e in range(E)],
        {"s2d2_unpack": 1}, _equal_each("s2d2_unpack")))
    del gp
    rows_per, o = f * (h // 4) * (w // 4), 64
    n_rows = b * rows_per
    y = randn((E, n_rows, 4 * o), torch.float32, 47)
    rows.append(check_vmap_rule(
        "phase_argmax",
        lambda: vmap(pt.PhaseArgmax.apply, in_dims=(0, None))(y, rows_per),
        lambda: [pt.PhaseArgmax.apply(y[e], rows_per) for e in range(E)],
        {"phase_argmax": 1}, _equal_each("phase_argmax")))
    _, idx = vmap(pt.PhaseArgmax.apply, in_dims=(0, None))(y, rows_per)
    rows.append(check_vmap_rule(
        "phase_select",
        lambda: vmap(pt.PhaseSelect.apply, in_dims=(0, 0, None))(
            y, idx, rows_per),
        lambda: [pt.PhaseSelect.apply(y[e], idx[e], rows_per)
                 for e in range(E)],
        {"phase_select": 1}, _equal_each("phase_select")))
    del y
    c = randn((E, b, o, rows_per), torch.float32, 48)
    rows.append(check_vmap_rule(
        "phase_scatter",
        lambda: vmap(pt.PhaseScatter.apply, in_dims=(0, 0, None))(
            c, idx, rows_per),
        lambda: [pt.PhaseScatter.apply(c[e], idx[e], rows_per)
                 for e in range(E)],
        {"phase_scatter": 1}, _equal_each("phase_scatter")))
    del c, idx
    emit({"phase": "check_vmap", "nets": E, "shape": EVAL_SHAPE,
          "rows": rows, "ok": True})


def phase_parity():
    """One small S2D-MTT step, kernels on the card vs the plain version on
    the CPU, from the same inputs, draws and dropout masks: fp32 with the
    fused first stage (the default), then the plain first stage in fp32 on
    both devices beside an fp64 CPU step, the reference each fp32 step is
    measured against (ROADMAP C.5)."""
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

    def run_step(dev, dtype, fused):
        def mv(t):
            t = t.to(dev)
            return t.to(getattr(torch, dtype)) if t.is_floating_point() else t
        st = {"static": mv(state["static"]), "dynamic": mv(state["dynamic"]),
              "hals": [{k: mv(v) for k, v in p.items()}
                       for p in state["hals"]]}
        step = S2DMTTStep("ConvNet3D", 3, nc, (im, im), f, steps, cfg, hyper,
                          dtype, dev)
        step.core.model.fuse_first_stage = fused
        return step(None, st, torch.tensor(0.01, device=dev),
                    init_s2d_momentum(st), torch.zeros((), device=dev),
                    mv(t0), mv(t1), mv(plan), draws=mv(draws),
                    keep_masks=mv(masks))

    def grad_rel(got, ref):
        """Relative-norm distance of each outer gradient from ref's."""
        pairs = {"dynamic": (got[7]["dynamic"], ref[7]["dynamic"]),
                 "syn_lr": (got[7]["syn_lr"], ref[7]["syn_lr"])}
        for k in ("weight", "bias"):
            pairs[f"hal.{k}"] = (got[7]["hals"][0][k], ref[7]["hals"][0][k])
        return {k: float((a.cpu().double() - r.cpu().double()).norm()
                         / r.cpu().double().norm())
                for k, (a, r) in pairs.items()}

    ref, got = run_step("cpu", "float32", True), run_step("cuda", "float32", True)
    loss_rel = abs(float(got[4]) - float(ref[4])) / abs(float(ref[4]))
    assert loss_rel <= 1e-5, f"parity: grand loss off by {loss_rel}"
    rel = grad_rel(got, ref)
    for k, v in rel.items():
        assert v <= 1e-3, f"parity: grad {k} off by {v} (rel norm)"

    # the plain first stage (Conv3d + ReLU + MaxPool): each device's fp32
    # outer gradients against the fp64 CPU step from the same draws; the
    # card's may stray at most 3x as far as the CPU's own fp32 step does,
    # or 1e-5 (fp32 rounding of a long sum), whichever is larger
    f64 = run_step("cpu", "float64", False)
    plain = {"cpu": grad_rel(run_step("cpu", "float32", False), f64),
             "cuda": grad_rel(run_step("cuda", "float32", False), f64)}
    for k, v in plain["cuda"].items():
        assert v <= max(3 * plain["cpu"][k], 1e-5), (
            f"parity: plain stage grad {k} {v} from fp64 on the card, over "
            f"3x the CPU's {plain['cpu'][k]}")
    emit({"phase": "parity", "loss_rel_err": loss_rel,
          "grad_rel_norm_err": rel,
          "plain_stage_grad_rel_norm_vs_fp64": plain, "ok": True})


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
        check_first_stage_counts(f"step {it}", {
            k: n * (it + 1) for k, n in per_step.items()})

    per_step = per_outer_step(SLICE["syn_steps"])
    torch.cuda.reset_peak_memory_stats()
    hc.reset_launches()
    reset_first_stage()
    run(cfg, data, logger, step_hook=hook)
    launches = dict(hc.LAUNCHES)
    steps = cfg.Iteration + 1
    for k, n in launches.items():
        assert n == steps, f"{k}: {n} launches in {steps} outer steps"
    launches.update(check_first_stage_counts(
        "slice", {k: n * steps for k, n in per_step.items()}))
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
    reset_first_stage()
    t_start = time.perf_counter()
    run(cfg, data, logger, step_hook=hook)
    emit({"phase": "slice", "compute_dtype": "float32", "outer_steps": 1,
          "seconds_with_setup": marks[0] - t_start, "grand_loss": losses,
          "max_memory_allocated_gb":
              torch.cuda.max_memory_allocated() / 2 ** 30})
    first_stage_ab(t0, t1)
    return launches


def first_stage_ab(t0, t1):
    """The fused first stage against the plain Conv3d + MaxPool stage:
    ``S2DMTTStep`` alone, bf16 at the slice's width, 1 warm-up + 3 timed
    steps each from the same state and plans, fused first."""
    nc, f, im, syn = (SLICE["num_classes"], SLICE["frames"], SLICE["im"],
                      SLICE["syn_steps"])
    cfg = S2DConfig(num_classes=nc, frames=f, im_size=(im, im))
    state = init_s2d_state(torch.Generator(device="cuda").manual_seed(0),
                           cfg, "cuda")
    res = {}
    for fused in (True, False):
        step = S2DMTTStep("ConvNet3D", 3, nc, (im, im), f, syn, cfg,
                          S2DHyper(100.0, 0.01, 0.01, 1e-5, False, True),
                          "bfloat16", "cuda")
        step.core.model.fuse_first_stage = fused
        rng = np.random.default_rng(0)
        torch.cuda.reset_peak_memory_stats()
        marks, losses = [], []
        for it in range(4):
            plan = torch.as_tensor(make_batch_plan(rng, nc, nc, syn),
                                   device="cuda")
            out = step(torch.Generator(device="cuda").manual_seed(it), state,
                       torch.tensor(0.01, device="cuda"),
                       init_s2d_momentum(state), torch.zeros((), device="cuda"),
                       t0, t1, plan)
            losses.append(float(out[4]))
            marks.append(time.perf_counter())
            bad = [k for k, v in out[7].items() if k != "hals" and not _finite(v)]
            if bad or not np.isfinite(losses[-1]):
                raise AssertionError(f"A/B fused={fused}: non-finite {bad}")
        res["fused" if fused else "plain"] = {
            "steps_per_sec": 3 / (marks[-1] - marks[0]),
            "step_seconds": np.diff(marks).tolist(), "grand_loss": losses,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}
    emit({"phase": "slice_first_stage_ab", "compute_dtype": "bfloat16",
          **res, "fused_over_plain_steps_per_sec":
              res["fused"]["steps_per_sec"] / res["plain"]["steps_per_sec"]})


def _movers(shape, dtype, seed):
    """pack and unpack against their plain versions, bit for bit; returns
    (unpack's max error, x, g)."""
    b, f, h, w, c = shape
    x = randn(shape, dtype, seed)
    check_equal(f"pack {dtype} {shape}", sm.pack(x), sm.pack_plain(x))
    g = randn((b, f, h // 2 + 4, w // 2 + 4, 12 * c), dtype, seed + 1)
    err = check_equal(f"unpack {dtype} {shape}", sm.unpack_sum(g, h, w),
                      sm.unpack_plain(g, h, w))
    return err, x, g


def _trio(n, o, rows, dtype, seed, ties):
    """The phase trio against its plain versions, m and c channel-planar
    with ``rows`` rows a batch; ``ties`` rounds y so that phases tie.
    Returns (share of outputs whose max ties, y, t, c, idx)."""
    y = randn((n, 4 * o), dtype, seed)
    if ties:
        y = (y * 2).round().to(dtype)
    t = randn((n, 4 * o), dtype, seed + 1)
    c = randn((n // rows, o, rows), dtype, seed + 2)
    m, idx = pt.phase_argmax(y, rows)
    rm, ridx = pt.phase_argmax_plain(y, rows)
    name = f"{dtype} N={n} ties={ties}"
    check_equal(f"phase_argmax m {name}", m, rm)
    check_equal(f"phase_argmax idx {name}", idx, ridx)
    check_equal(f"phase_select {name}", pt.phase_select(t, idx, rows),
                pt.phase_select_plain(t, idx, rows))
    check_equal(f"phase_scatter {name}", pt.phase_scatter(c, idx, rows),
                pt.phase_scatter_plain(c, idx, rows))
    m_rows = m.transpose(1, 2).reshape(n, 1, o)
    tied = float(((y.view(n, 4, o) == m_rows).sum(1) > 1).float().mean())
    return tied, y, t, c, idx


def phase_check_first_stage():
    """The five first-stage kernels against their plain versions (fp32
    small, bf16 at the slice's inner-step shape, random and tied inputs),
    then timed at the slice's shape."""
    # F = 1, a generic C, an odd packed width, rows (and a bf16 tensor)
    # whose byte length is not a multiple of 16, and F = 9 (two of unpack's
    # 8-frame blocks)
    for shape in ((2, 4, 16, 16, 3), (1, 1, 12, 8, 3), (3, 2, 16, 20, 2),
                  (1, 3, 10, 14, 3), (1, 3, 2, 6, 1), (2, 9, 4, 112, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            _movers(shape, dtype, 10)
    for n, o, rows in ((100, 64, 25), (77, 8, 7), (64, 40, 64)):
        for ties in (False, True):
            _trio(n, o, rows, torch.float32, 11, ties)
    emit({"phase": "check_first_stage_fp32", "ok": True})

    b, f, im = SLICE["num_classes"], SLICE["frames"], SLICE["im"]
    ho = im // 4
    n, o, rows = b * f * ho * ho, 64, f * ho * ho
    unpack_err, x, g = _movers((b, f, im, im, 3), torch.bfloat16, 12)
    tied = {}
    for ties in (True, False):  # the untied inputs are the ones timed
        tied[ties], y, t, c, idx = _trio(n, o, rows, torch.bfloat16, 13, ties)
    emit({"phase": "check_first_stage_bf16", "pack_shape": tuple(x.shape),
          "trio_rows": n, "tied_share": tied, "unpack_max_abs_err": unpack_err,
          "ok": True})

    idx64 = idx.long().unsqueeze(1)
    c_rows = c.transpose(1, 2).reshape(n, 1, o)
    e, xv = 2, b * f * (im // 2 + 4) ** 2 * 36  # bf16; packed elements
    # (kernel, plain, library call or None, bytes moved, fp32 operations)
    ms = {
        "s2d2_pack": (lambda: sm.pack(x), lambda: sm.pack_plain(x), None,
                      e * (x.numel() + xv), 0),
        "s2d2_unpack": (lambda: sm.unpack_sum(g, im, im),
                        lambda: sm.unpack_plain(g, im, im), None,
                        e * (xv + x.numel()), 2 * x.numel()),
        "phase_argmax": (lambda: pt.phase_argmax(y, rows),
                         lambda: pt.phase_argmax_plain(y, rows),
                         lambda: y.view(n, 4, o).max(1),
                         e * 5 * n * o + n * o, 3 * n * o),
        "phase_select": (lambda: pt.phase_select(t, idx, rows),
                         lambda: pt.phase_select_plain(t, idx, rows),
                         lambda: torch.gather(t.view(n, 4, o), 1, idx64),
                         e * 5 * n * o + n * o, 0),
        "phase_scatter": (lambda: pt.phase_scatter(c, idx, rows),
                          lambda: pt.phase_scatter_plain(c, idx, rows),
                          lambda: torch.zeros(n, 4, o, device="cuda",
                                              dtype=c.dtype).scatter_(
                              1, idx64, c_rows),
                          e * 5 * n * o + n * o, 0),
    }
    bw, peak, _ = card_peaks(torch.cuda.get_device_name(0))
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in ms.items():
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": FIRST_STAGE_SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": unpack_err if name == "s2d2_unpack" else 0.0,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else cuda_ms(lib, 5)}
    # pack also runs once per evaluation training step: fp32, B=50
    xe = randn((*EVAL_SHAPE, 3), torch.float32, 14)
    check_equal("pack fp32 evaluation shape", sm.pack(xe), sm.pack_plain(xe))
    pack_eval = {"shape": tuple(xe.shape),
                 "ms": cuda_ms(lambda: sm.pack(xe), 20),
                 "plain_ms": cuda_ms(lambda: sm.pack_plain(xe), 3),
                 "bound_ms": 4 * xe.numel() * (1 + 12 * (im // 2 + 4) ** 2
                                               / im ** 2) / bw * 1e3}
    emit({"phase": "times", "rows": list(out.values()),
          "s2d2_pack_fp32_eval": pack_eval})
    return out


# hal_fused beside its plain version and hal_fwd at small shapes: widths
# that are not a multiple of 4 (the kernel's element paths), F = 1 and 2,
# H = 1, and a batch whose runs end inside a block
FUSED_SMALL = [(4, 8, 32, 32), (2, 1, 9, 13), (1, 2, 16, 113), (3, 4, 1, 112),
               (3, 5, 7, 20)]


def c_ms(fn, name, iters=50):
    """Device time of a C-interface launch (its cudaError_t checked) over
    ``iters`` back-to-back calls after warm-up."""
    def call():
        hc._check_rc(fn(), name)
    return cuda_ms(call, iters, warmup=3)


def phase_check_fused():
    """hal_fused against its plain version and hal_fwd (fp32) at small
    shapes and at the evaluation shape; times at the evaluation shape."""
    for k, shape in enumerate(FUSED_SMALL):
        st, dy, wt, bs, _ = inputs(*shape, torch.float32, 20 + k)
        y = hf.hal_fused(st, dy, wt, bs)
        check_max(f"hal_fused fp32 {shape}", y,
                  hf.hal_fused_plain(st, dy, wt, bs), 1e-5)
        check_max(f"hal_fused vs hal_fwd {shape}", y,
                  hc.hal_fwd(st, dy, wt, bs).permute(0, 2, 3, 4, 1), 1e-5)

    b, f, h, w = EVAL_SHAPE
    st, dy, wt, bs, _ = inputs(b, f, h, w, torch.float32, 3)
    y = hf.hal_fused(st, dy, wt, bs)
    err = check_max("hal_fused fp32 eval shape", y,
                    hf.hal_fused_plain(st, dy, wt, bs), 1e-5)
    check_max("hal_fused vs hal_fwd eval shape", y,
              hc.hal_fwd(st, dy, wt, bs).permute(0, 2, 3, 4, 1), 1e-5)
    if not torch.equal(y, hf.hal_fused(st, dy, wt, bs)):
        raise AssertionError("hal_fused: two calls differ")
    del y
    emit({"phase": "check_fused", "shapes": [*FUSED_SMALL, EVAL_SHAPE],
          "max_abs_err": err, "ok": True})

    # the library call is cuDNN's conv3d on the materialised 4-channel input
    x4 = torch.cat([st.permute(0, 3, 1, 2).unsqueeze(2).expand(b, 3, f, h, w),
                    dy.permute(0, 4, 1, 2, 3)], dim=1).contiguous()
    bw, peak, _ = card_peaks(torch.cuda.get_device_name(0))
    hw = h * w
    # bytes: each fp32 input read once and y written once; operations: the
    # temporally collapsed form the kernel computes (243 static FMAs per
    # pixel, 81 dynamic FMAs and up to 3 adds per output pixel and frame),
    # the fewest of any formulation (the direct 27x4x3-tap form does 3.3x)
    nbytes = 4 * b * hw * (3 + f + 3 * f) + 4 * 327
    flops = b * hw * (2 * 243 + f * (2 * 81 + 3))
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    # the kernel alone: its C interface on weights flattened once, so the
    # wrapper's checks, weight flattening and allocation are left out
    wb = hc._flat_weights(wt, bs)
    yk = torch.empty(b, 3, f, h, w, device="cuda")
    ptrs = (st.data_ptr(), dy.data_ptr(), wb.data_ptr(), yk.data_ptr())
    kernel_ms = c_ms(lambda: hf._lib().hal_fused(*ptrs, b, f, h, w, hc._stream()),
                     "hal_fused")
    row = {"name": "hal_fused", "route": "cuda", "source": FUSED_SOURCE,
           "replaces": REPLACES["hal_fused"], "launches": None,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: hf.hal_fused(st, dy, wt, bs), 50, warmup=3),
           "kernel_ms": kernel_ms,
           "plain_ms": cuda_ms(lambda: hf.hal_fused_plain(st, dy, wt, bs), 5),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": cuda_ms(lambda: torch.nn.functional.conv3d(
               x4, wt, bs, padding=1), 5)}
    # hal_fwd computes the same function in fp32 too (with autograd's
    # saved-tensor contract); its time on these inputs, through its wrapper
    # and alone, beside hal_fused's
    hal_fwd_ms = cuda_ms(lambda: hc.hal_fwd(st, dy, wt, bs), 50, warmup=3)
    hal_fwd_kernel_ms = c_ms(lambda: hc._lib().hal_fwd(
        0, *ptrs, b, f, h, w, hc._stream()), "hal_fwd")
    emit({"phase": "times", "rows": [row], "hal_fwd_fp32_ms": hal_fwd_ms,
          "hal_fwd_fp32_kernel_ms": hal_fwd_kernel_ms,
          "hal_fused_wrapper_extra_ms": row["ms"] - kernel_ms})
    return row


class RecordingLogger(MetricLogger):
    def __init__(self):
        super().__init__(quiet=True)
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))


def _synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_pipeline(tmp):
    """Expert buffer -> S2D-MTT distillation -> multi-static evaluation,
    through the drivers, at full width."""
    p = PIPELINE
    buf_dir = os.path.join(tmp, "pipeline_buffers")
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launches()
    reset_first_stage()
    expert_s, paths = _synced_seconds(lambda: buffer_driver.main([
        "--dataset", p["dataset"], "--num_experts", "1", "--save_interval",
        "1", "--train_epochs", str(p["expert_epochs"]), "--buffer_path",
        buf_dir, "--compute_dtype", "bfloat16", "--device", "cuda"]))
    traj = TrajectoryBuffer.load(paths[0]).trajectories
    assert traj.shape[:2] == (1, p["expert_epochs"] + 1), traj.shape
    moved = [float(np.sum((traj[0, e + 1] - traj[0, e]) ** 2))
             for e in range(p["expert_epochs"])]
    assert all(m > 0 for m in moved), f"a snapshot pair did not move: {moved}"

    cfg = get_preset("s2d_MTT_ms")
    cfg.s2d = True
    cfg.dataset, cfg.buffer_path = p["dataset"], buf_dir
    cfg.save_path = os.path.join(tmp, "pipeline_out")
    cfg.Iteration, cfg.max_start_epoch = p["iterations"], p["expert_epochs"] - 1
    cfg.startIt, cfg.eval_it = 0, p["eval_it"]
    cfg.num_eval, cfg.epoch_eval_train = p["num_eval"], p["epoch_eval_train"]
    cfg.compute_dtype, cfg.device = "bfloat16", "cuda"
    data = load_data(cfg)
    # one expert step an epoch per ceil(train clips / batch_train=256)
    expert_steps = p["expert_epochs"] * -(-len(data.train)
                                          // BufferConfig().batch_train)
    check_first_stage_counts("pipeline experts", first_order(expert_steps))
    logger = RecordingLogger()
    hf.reset_launches()
    reset_first_stage()
    distill_s, holder = _synced_seconds(lambda: run(cfg, data, logger))
    launches = hf.LAUNCHES["hal_fused"]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the evaluations run batched (vmap_eval, the default): one hal_fused
    # launch per batched training step for all nets (n_hal=1; all 50
    # synthetic videos fit one batch of batch_train=256, so one step per
    # epoch), per evaluation; the PNG grids compose through hal_conv and
    # add none
    assert cfg.vmap_eval
    n_evals = len(range(cfg.startIt, cfg.Iteration + 1, cfg.eval_it))
    expect = (cfg.epoch_eval_train + 1) * n_evals
    assert launches == expect, f"hal_fused: {launches} launches, {expect} expected"
    # the first stage: the outer steps, each batched evaluation training
    # step, and each test batch, one forward of all nets (test_repeats
    # passes over ceil(N_test/64) batches, no grad)
    outer = cfg.Iteration + 1
    test_forwards = (n_evals * EvalConfig().test_repeats
                     * -(-len(data.test) // TEST_BATCH))
    want = first_order(expect, test_forwards)
    for k, n in per_outer_step(cfg.syn_steps).items():
        want[k] += outer * n
    first_stage = check_first_stage_counts("pipeline distillation", want)
    accs = [(step, m["Accuracy/ConvNet3D"]) for step, m in logger.records
            if "Accuracy/ConvNet3D" in m]
    assert [s for s, _ in accs] == [0, 2], accs
    assert all(np.isfinite(a) and 0.0 <= a <= 1.0 for _, a in accs), accs
    out_dir = os.path.join(cfg.save_path, f"S2D_multis_MTT_{cfg.dataset}")
    with np.load(os.path.join(out_dir, "hal_0.npz")) as z:
        assert sorted(z.files) == ["[0]['bias']", "[0]['kernel']"], z.files
        assert z["[0]['kernel']"].shape == (3, 3, 3, 4, 3)
    dyn = np.load(os.path.join(out_dir, "dynamic_0.npy"))
    assert dyn.shape == (100, 16, 112, 112, 1) and np.isfinite(dyn).all()
    pngs = sorted(os.listdir(os.path.join(out_dir, "png")))
    assert {"static_000000.png", "dynamic_000000.png",
            "videos_000000.png"} <= set(pngs), pngs

    # on the distilled state: one evaluation point of VMAP_NETS nets,
    # batched and sequential (fp32, B=50), each with its training and test
    # parts and its peak memory; then one batched step against the nets'
    # sequential steps
    meta = data.meta
    ecfg = EvalConfig(model=cfg.model, epoch_eval_train=cfg.epoch_eval_train,
                      lr_net=float(holder["syn_lr"]), batch_train=cfg.batch_train,
                      mode="multi-static")
    s2d_cfg = S2DConfig(num_classes=meta.num_classes, frames=meta.frames,
                        im_size=tuple(meta.im_size))
    points = {mode: eval_point(data, ecfg, s2d_cfg, holder["state"], mode)
              for mode in ("batched", "sequential", "sequential_again",
                           "batched_again")}
    test_batches = EvalConfig().test_repeats * -(-len(data.test) // TEST_BATCH)
    seq_step_ms = points["sequential_again"]["train_s"] / (
        VMAP_NETS * (cfg.epoch_eval_train + 1)) * 1e3
    test_batch_ms = points["sequential_again"]["test_s"] / (
        VMAP_NETS * test_batches) * 1e3
    # the paper's protocol at this width: 501 epochs, and the test part
    # per 1000 test videos (the synthetic split has only 100)
    paper = {mode: {"train_seconds": (PAPER_EVAL["epoch_eval_train"] + 1)
                    * point["train_s"] / (cfg.epoch_eval_train + 1),
                    "test_seconds_per_1000_videos":
                        point["test_s"] / test_batches
                        * EvalConfig().test_repeats * -(-1000 // TEST_BATCH)}
             for mode, point in points.items()}
    emit({"phase": "pipeline", "dataset": p["dataset"],
          "expert_driver_seconds": expert_s,
          "distill_run_seconds": distill_s,
          "accuracy": accs, "snapshot_sq_moves": moved,
          "hal_fused_launches": launches,
          "first_stage_launches": first_stage,
          "max_memory_allocated_gb": peak_gb,
          "eval_point": points, "eval_nets": VMAP_NETS,
          "ms_per_eval_train_step": seq_step_ms,
          "ms_per_test_batch": test_batch_ms,
          "test_clips_per_pass": len(data.test) * ecfg.test_repeats,
          "paper_eval_point": paper,
          "batched_step_vs_sequential": check_batched_step(
              meta, ecfg, s2d_cfg, holder["state"])})
    return launches, dict(cfg=cfg, data=data, holder=holder, buffer=paths[0],
                          buf_dir=buf_dir, out_dir=out_dir)


def eval_point(data, ecfg, s2d_cfg, state, mode):
    """One evaluation point of VMAP_NETS nets on ``state`` through
    ``evaluate_many``, batched or one net after the other: its synced
    seconds, training and test parts, peak memory and accuracies."""
    parts = {"train": [], "test": []}
    saved = (evaluate.train_synsets, evaluate.train_synset,
             evaluate.run_test_pass)
    evaluate.train_synsets = _timed(saved[0], parts["train"])
    evaluate.train_synset = _timed(saved[1], parts["train"])
    evaluate.run_test_pass = _timed(saved[2], parts["test"])
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        total, (results, mean, _) = _synced_seconds(lambda: evaluate_many(
            gen, VMAP_NETS, None, None, data, ecfg, np.random.default_rng(0),
            s2d_cfg, state, vmap_eval=mode.startswith("batched")))
    finally:
        (evaluate.train_synsets, evaluate.train_synset,
         evaluate.run_test_pass) = saved
    accs = [r.top1 for r in results]
    assert all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs), accs
    return {"seconds": total, "train_s": sum(parts["train"]),
            "test_s": sum(parts["test"]), "top1": accs,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}


@contextlib.contextmanager
def phase_max_log(log):
    """Record each phase max's winners (the (rows, O) uint8 index, on the
    CPU) while the block runs: the folded batched call's or each net's."""
    orig = pt.phase_argmax

    def phase(y, rows_per_batch):
        m, idx = orig(y, rows_per_batch)
        log.append(idx.cpu())
        return m, idx

    pt.phase_argmax = phase
    try:
        yield log
    finally:
        pt.phase_argmax = orig



def check_batched_step(meta, ecfg, s2d_cfg, state):
    """One batched evaluation training step of VMAP_NETS nets against each
    net's sequential step from the same draws (initial θ, permutation,
    slot draws, dropout keep-mask): each net's change of θ within 1e-5
    relative norm, or within 1e-2 where a phase max of the batched forward
    picked another winner than the net's sequential forward (ROADMAP
    C.13; later max-pools are not compared)."""
    cfg1 = dataclasses.replace(ecfg, epoch_eval_train=0)  # one step
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_syn = s2d_cfg.num_classes
    bt = min(cfg1.batch_train, n_syn)
    model, theta0, _ = evaluate.fresh_net(cfg1.model, meta, meta.frames, gen,
                                          "cuda")
    shape = model.keep_mask_shape(meta.frames, *meta.im_size)
    draws, masks = [], []
    for e in range(VMAP_NETS):
        _, th, _ = evaluate.fresh_net(cfg1.model, meta, meta.frames, gen, "cuda")
        rng = np.random.default_rng(100 + e)
        draws.append(EvalDraws(
            theta=th.cpu().numpy(), perms=rng.permutation(n_syn)[None],
            slots=[[rng.integers(0, hi, bt) for hi in (s2d_cfg.spc,
                                                       s2d_cfg.dpc, 1)]]))
        masks.append(torch.as_tensor(rng.random((1, bt) + shape) < 0.5,
                                     device="cuda"))
    blog, slog = [], []
    with phase_max_log(blog):
        (thetas, _, _), n = launched(lambda: train_synsets(
            None, VMAP_NETS, None, None, meta, cfg1, s2d_cfg, state, draws,
            masks))
    want = {"hal_fused": 1, "s2d2_pack": 1, "phase_argmax": 1,
            "phase_scatter": 1}
    if n != want:
        raise AssertionError(f"batched step: launches {n}, expected {want}")
    rows = []
    for e in range(VMAP_NETS):
        with phase_max_log(slog):
            th, _, _ = train_synset(None, None, None, meta, cfg1, s2d_cfg,
                                    state, draws[e], masks[e])
        start = torch.as_tensor(draws[e].theta, device="cuda")
        db, ds = (thetas[e] - start).double(), (th - start).double()
        err = float((db - ds).norm() / ds.norm())
        rows_n = slog[-1].shape[0]
        flipped = int((blog[0][e * rows_n:(e + 1) * rows_n] != slog[-1]).sum())
        cap = 1e-5 if flipped == 0 else 1e-2
        if not err <= cap:
            raise AssertionError(f"batched step net {e}: θ change {err} from "
                                 f"the sequential step's (cap {cap}, "
                                 f"{flipped} phase-max flips)")
        rows.append({"net": e, "rel_err": err, "phase_max_flips": flipped})
    return rows




def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _same_bytes(a, b):
    """Two npz files with the same members (the zip stamps the time of
    writing), or two files with the same bytes."""
    if a.endswith(".npz"):
        return _members(a) == _members(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_convert(tmp, pipe):
    """The pipeline's own artifacts through the port's converter
    (``drivers.convert``, its CLI) to the reference's ``.pt`` and back, each
    byte-equal to the file it came from: the expert buffer, ``hal_0.npz``,
    ``dynamic_0.npy`` and the static memory as an NHWC ``.npy``; then one
    S2D-MTT step from the static that went ``.npy`` -> ``.pt`` -> ``.npy``."""
    t0 = time.perf_counter()
    cfg, data, holder = pipe["cfg"], pipe["data"], pipe["holder"]
    meta = data.meta
    work, back = os.path.join(tmp, "convert"), os.path.join(tmp, "convert_back")
    os.makedirs(work), os.makedirs(back)
    static = os.path.join(work, "images_0.npy")
    np.save(static, holder["state"]["static"].cpu().numpy())
    dims = ["--model", cfg.model, "--num_classes", str(meta.num_classes),
            "--im_size", *map(str, meta.im_size), "--frames", str(meta.frames)]
    sources = {"buffer": pipe["buffer"],
               "hal": os.path.join(pipe["out_dir"], "hal_0.npz"),
               "dynamic": os.path.join(pipe["out_dir"], "dynamic_0.npy"),
               "static": static}
    rows = {}
    for kind, src in sources.items():
        name, ext = os.path.basename(src).rsplit(".", 1)
        pt_path = os.path.join(work, f"{name}.pt")
        again = os.path.join(back, f"{name}.{ext}")
        extra = dims if kind == "buffer" else []
        convert.main([kind, src, pt_path, *extra])
        convert.main([kind, pt_path, again, *extra])
        if not _same_bytes(src, again):
            raise AssertionError(f"convert {kind}: {src} -> .pt -> {again} "
                                 "changed the bytes")
        rows[kind] = {"bytes": os.path.getsize(src),
                      "pt_bytes": os.path.getsize(pt_path)}
    c2 = dataclasses.replace(cfg, path_static=os.path.join(back, "images_0.npy"),
                             save_path=os.path.join(tmp, "convert_out"),
                             Iteration=0, startIt=1)
    losses = []
    out = run(c2, data, MetricLogger(quiet=True),
              step_hook=lambda it, o: losses.append(float(o[4])))
    want = torch.as_tensor(np.load(c2.path_static), device="cuda")
    assert torch.equal(out["state"]["static"], want), "static not as loaded"
    assert len(losses) == 1 and np.isfinite(losses[0]), losses
    emit({"phase": "convert", "artifacts": rows, "s2d_step_loss": losses[0],
          "seconds": time.perf_counter() - t0, "ok": True})


# the VideoConvNet family at full width: two heads evaluated (VMAP_NETS
# nets batched, 3 epochs of one step on the 50-clip set; the evaluation's
# 24:-24 crop makes 64x64 input), one raw DM step with a third
ZOO = dict(eval_models=("VideoConvNetMean", "VideoConvNetLSTM"),
           dm_model="VideoConvNetGRU", epoch_eval_train=2)


def phase_zoo(data_path, tmp):
    """The VideoConvNets on the baselines' store (50 classes, 112x112x16):
    ``train_synsets`` (after a one-step run) and the batched test pass for
    ZOO's evaluation models on a raw one-clip-a-class set, and one raw DM
    step (the first at its shapes) through
    ``distill_baseline.main`` with ZOO's DM model. Finite parameters and
    losses, accuracies in [0, 1], none of the port's kernels launched (a
    VideoConvNet is a 2-D ConvNet a frame); ms a step, peak memory."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_preset("DM")
    cfg.dataset, cfg.data_path, cfg.device = BASELINES["dataset"], data_path, "cuda"
    data = load_data(cfg)
    meta = data.meta
    syn, labels = init_synthetic_raw(None, data.train, 1, meta.frames, "real",
                                     np.random.default_rng(0), "cuda")
    rows = {}
    for name in ZOO["eval_models"]:
        ecfg = EvalConfig(model=name, epoch_eval_train=ZOO["epoch_eval_train"],
                          lr_net=0.01, batch_train=256)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        # a one-step run first: cuDNN's first calls at these shapes
        warm_s = _synced_seconds(lambda: train_synsets(
            gen, VMAP_NETS, syn, labels, meta,
            dataclasses.replace(ecfg, epoch_eval_train=0)))[0]
        train_s, (thetas, model, acc_train) = _synced_seconds(
            lambda: train_synsets(gen, VMAP_NETS, syn, labels, meta, ecfg))
        batches = sample_test_batches(data, ecfg, np.random.default_rng(0),
                                      "cuda")
        test_s, tested = _synced_seconds(
            lambda: run_test_pass(model, thetas, meta, ecfg, batches))
        assert _finite(thetas), f"{name}: non-finite parameters"
        top1 = [t[0] for t in tested]
        assert all(0.0 <= a <= 1.0 for a in top1 + acc_train), (top1, acc_train)
        assert all_launches() == {}, f"{name}: launched {all_launches()}"
        rows[name] = {"params_per_net": int(thetas.shape[1]),
                      "first_run_one_step_seconds": warm_s,
                      "ms_per_batched_step":
                          train_s / (ecfg.epoch_eval_train + 1) * 1e3,
                      "test_pass_seconds": test_s, "acc_train": acc_train,
                      "top1": top1, "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 2 ** 30}
        del thetas, model
        torch.cuda.empty_cache()
    steps, losses = [], []

    def check(out):
        state, loss = out
        losses.append(float(loss))
        if not (np.isfinite(losses[-1]) and _finite(state.syn_images)):
            raise AssertionError("zoo DM: non-finite loss or images")
        if all_launches():
            raise AssertionError(f"zoo DM: launched {all_launches()}")

    real, chunks = [], []
    saved = dm._DMTrainerBase.real_feats

    def real_feats(self, *args):
        chunks.append(self.chunk)
        return _timed(saved, real)(self, *args)

    torch.cuda.reset_peak_memory_stats()
    dm._DMTrainerBase.real_feats = real_feats
    try:
        with checked_steps(dm.DMTrainer, check, steps):
            distill_baseline.main(
                ["--preset", "DM", "--model", ZOO["dm_model"],
                 *_common_argv(data_path, os.path.join(tmp, "zoo_dm"), 0,
                               False)],
                logger=MetricLogger(quiet=True))
    finally:
        dm._DMTrainerBase.real_feats = saved
    rows[ZOO["dm_model"]] = {
        "dm_ms_per_step": steps[0] * 1e3, "dm_ms_real_embed": real[0] * 1e3,
        "dm_loss": losses, "real_clips_per_chunk": chunks[0],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit({"phase": "zoo", "models": rows,
          "seconds": time.perf_counter() - t0, "ok": True})


# the image side at CIFAR10's size (its meta: 10 classes, 32x32x3; 5,000
# training and 1,000 test images a class, made from a seed as class means
# plus noise): distill_coreset's pool 'M' at ipc 10 with 3 nets, one after
# the other as the driver runs them and then batched, epoch_eval_train cut
# to 20 (its default: 1000); raw DM (ConvNet, ipc 10,
# batch_real 256, fp32, 1 + 3 steps); raw FRePo (ConvNet, ppc 10, 3 steps)
IMAGES = dict(dataset="CIFAR10", train_per_class=5000, test_per_class=1000,
              noise=40.0, ipc=10, num_eval=3, epoch_eval_train=20,
              driver_epochs=1000, dm_batch_real=256, dm_iterations=3,
              frepo_steps=3, check_batch=50, seed=0)
IMAGE_POOL = ("MLP", "ConvNet", "LeNet", "AlexNet", "VGG11", "ResNet18")
IMAGE_STEP_NETS = IMAGE_POOL + ("Conv", "KIP_ConvNet")
# the BatchNorm nets of the pools 'B' and 'N', and FRePo's KIP_ConvNet with
# its 'batch' norm (flax momentum 0.1)
IMAGE_BN_NETS = ("ConvNetBN", "AlexNetBN", "VGG11BN", "ResNet18BN",
                 "KIP_ConvNet_batch")


def image_store(tmp):
    """The CIFAR10-sized store through ``from_arrays`` and ``save_packed``;
    returns its data path."""
    c = IMAGES
    rng = np.random.default_rng(c["seed"])
    mu = rng.integers(40, 215, size=(10, 3)).astype(np.float32)

    def split(per_class):
        y = np.repeat(np.arange(10), per_class)
        x = np.empty((len(y), 32, 32, 3), np.uint8)
        for i in range(0, len(y), 5000):
            part = y[i:i + 5000]
            noise = rng.standard_normal((len(part), 32, 32, 3),
                                        dtype=np.float32) * c["noise"]
            x[i:i + 5000] = np.clip(mu[part][:, None, None] + noise, 0, 255)
        return x, y

    data = from_arrays(c["dataset"], *split(c["train_per_class"]),
                       *split(c["test_per_class"]))
    path = os.path.join(tmp, "images_data")
    save_packed(os.path.join(path, f"{c['dataset']}_packed"), data)
    return path


def images_coreset(data_path, data):
    """k-center through ``distill_coreset.main`` on the store as users run
    it: each pool-M net's ``num_eval`` nets trained one after the other
    (the timers pass every call through unchanged). Then each net's
    batched evaluation (``evaluate_many(..., vmap_eval=True)``, the default
    of the distillation drivers) of the selected set, timed around the
    call and in its training and test pass (pass-through timers), with
    seconds per point scaled to the driver's default 1000 epochs. Peak memory, accuracies; none of the
    port's kernels."""
    c = IMAGES
    select_s, seq_s = [], []
    saved = (distill_coreset.select_coreset, distill_coreset.evaluate_many)
    distill_coreset.select_coreset = _timed(saved[0], select_s)
    distill_coreset.evaluate_many = _timed(saved[1], seq_s)
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        run_s, (syn, labels, accs) = _synced_seconds(
            lambda: distill_coreset.main(
                ["--dataset", c["dataset"], "--data_path", data_path,
                 "--model", "ConvNet", "--ipc", str(c["ipc"]),
                 "--eval_mode", "M", "--num_eval", str(c["num_eval"]),
                 "--epoch_eval_train", str(c["epoch_eval_train"]),
                 "--seed", str(c["seed"]), "--device", "cuda"],
                logger=MetricLogger(quiet=True)))
    finally:
        distill_coreset.select_coreset, distill_coreset.evaluate_many = saved
    if all_launches():
        raise AssertionError(f"coreset driver: launched {all_launches()}")
    driver_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    store = data.train
    assert syn.shape == (10 * c["ipc"], 32, 32, 3), syn.shape
    assert labels.tolist() == np.repeat(np.arange(10), c["ipc"]).tolist()
    for v, k in zip(syn, labels.tolist()):
        idx = np.nonzero(store.labels == k)[0]
        clips = store.normalize(torch.as_tensor(np.asarray(store.clips[idx]),
                                                device="cuda"))
        if not (clips == v).flatten(1).all(1).any():
            raise AssertionError(f"coreset: an image of class {k} is not "
                                 "from that class")
    assert list(accs) == list(IMAGE_POOL), accs
    assert len(seq_s) == len(IMAGE_POOL), seq_s

    rows = {}
    epochs = c["epoch_eval_train"] + 1
    for i, name in enumerate(IMAGE_POOL):
        # the driver's EvalConfig (its --lr_net 0.001, --batch_train 256)
        ecfg = EvalConfig(model=name, epoch_eval_train=c["epoch_eval_train"],
                          lr_net=0.001, batch_train=256, eval_mode="M")
        gen = torch.Generator(device="cuda").manual_seed(c["seed"] + i)
        train_s, test_s = [], []
        saved_parts = (evaluate.train_synsets, evaluate.run_test_pass)
        evaluate.train_synsets = _timed(saved_parts[0], train_s)
        evaluate.run_test_pass = _timed(saved_parts[1], test_s)
        reset_all_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            point_s, (out, _, _) = _synced_seconds(lambda: evaluate_many(
                gen, c["num_eval"], syn, labels, data, ecfg,
                np.random.default_rng(c["seed"]), vmap_eval=True))
        finally:
            evaluate.train_synsets, evaluate.run_test_pass = saved_parts
        if all_launches():
            raise AssertionError(f"{name}: launched {all_launches()}")
        mean, std = accs[name]
        top1 = [r.top1 for r in out]
        acc_train = [r.acc_train for r in out]
        assert all(0.0 <= a <= 1.0 for a in top1 + acc_train + [mean]), (
            name, top1, acc_train, mean)
        rows[name] = {
            "driver_sequential_s": seq_s[i],
            "driver_top1_mean": mean, "driver_top1_std": std,
            "batched_point_s": point_s, "batched_train_s": train_s[0],
            "batched_test_pass_s": test_s[0],
            # the training scaled, the rest (test pass, sampling the test
            # batches) once
            "batched_s_per_point_at_driver_epochs":
                point_s + train_s[0] * ((c["driver_epochs"] + 1) / epochs - 1),
            "batched_top1": top1, "batched_acc_train": acc_train,
            "batched_max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30}
    emit({"phase": "images_coreset", "driver_seconds": run_s,
          "selection_seconds": select_s[0],
          "driver_max_memory_allocated_gb": driver_gb, "nets": rows,
          "ok": True})


def images_dm(data_path, tmp):
    """Raw DM through ``distill_baseline.main`` (the DM preset, fp32) with
    ConvNet on the store: the (N, 1, H, W, C) set of the JAX package, 1 +
    3 steps, each with no kernel of the port launched; ms a step."""
    c = IMAGES
    steps, losses = [], []

    def check(out):
        state, loss = out
        losses.append(float(loss))
        if not (np.isfinite(losses[-1]) and _finite(state.syn_images)):
            raise AssertionError("images DM: non-finite loss or images")
        assert state.syn_images.shape == (10 * c["ipc"], 1, 32, 32, 3)
        if all_launches():
            raise AssertionError(f"images DM: launched {all_launches()}")

    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with checked_steps(dm.DMTrainer, check, steps):
        distill_baseline.main(
            ["--preset", "DM", "--dataset", c["dataset"], "--data_path",
             data_path, "--model", "ConvNet", "--ipc", str(c["ipc"]),
             "--batch_real", str(c["dm_batch_real"]),
             "--Iteration", str(c["dm_iterations"]),
             "--startIt", str(c["dm_iterations"] + 1),
             "--save_path", os.path.join(tmp, "images_dm"),
             "--seed", str(c["seed"]), "--device", "cuda"],
            logger=MetricLogger(quiet=True))
    assert len(steps) == c["dm_iterations"] + 1, steps
    emit({"phase": "images_dm", "losses": losses,
          "ms_per_step": float(np.mean(steps[1:])) * 1e3,
          "first_step_ms": steps[0] * 1e3,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "ok": True})


def images_frepo(data):
    """Raw FRePo (``s2d=False``, ``frames=1``) with ConvNet on the store,
    the trainer's defaults otherwise (10 pool nets, batch_real 512): 3
    steps of finite loss that move the prototypes; no kernel launched."""
    c = IMAGES
    cfg = frepo.FRePoConfig(num_classes=10, ppc=c["ipc"], dpc=c["ipc"],
                            frames=1, im_size=(32, 32), s2d=False)
    tr = frepo.FRePoTrainer(data.train, "ConvNet", cfg,
                            torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    before = tr.compose_eval().clone()
    np_rng = np.random.default_rng(0)
    steps, losses = [], []
    reset_all_launches()
    for it in range(c["frepo_steps"]):
        gen = torch.Generator(device="cuda").manual_seed(it)
        losses.append(_timed(tr.step, steps)(gen, np_rng)["loss"])
    after = tr.compose_eval()
    assert all(np.isfinite(losses)), losses
    assert after.shape == (10 * c["ipc"], 32, 32, 3)
    assert not torch.equal(after, before)
    assert all_launches() == {}, all_launches()
    emit({"phase": "images_frepo", "losses": losses,
          "ms_per_step": float(np.mean(steps[1:])) * 1e3, "ok": True})


@contextlib.contextmanager
def image_pool_log(log):
    """Append each max-pool's winners of the image nets built and run in
    the block to ``log`` (their gradients follow them, ROADMAP C.13)."""
    orig = classic.max_pool

    def pool(x, window, strides=None):
        _, idx = torch.nn.functional.max_pool2d(
            x.detach(), tuple(window), stride=tuple(strides or window),
            return_indices=True)
        log.append({"kind": "max_pool", "idx": idx.cpu()})
        return orig(x, window, strides)

    classic.max_pool = pool
    try:
        yield log
    finally:
        classic.max_pool = orig


def _image_net(name, device, dtype):
    if name == "KIP_ConvNet_batch":
        return frepo_nets.KIPConvNet(3, 10, normalization="batch",
                                     generator=torch.Generator().manual_seed(0),
                                     device="cpu").to(device, dtype)
    return create_model(name, 3, 10, (32, 32), 1, device="cpu",
                        generator=torch.Generator().manual_seed(0)).to(
                            device, dtype)


def check_images_card_vs_cpu(data):
    """One training step of each pool-M net and of Conv and KIP_ConvNet,
    and the BatchNorm modules' train-mode forward (with its running
    update) and eval-mode forward, from the same θ and batch (the store's
    first images, normalised) in fp32 on the card and on the CPU, each
    against an fp64 CPU run. The card must be within 3x of the CPU fp32
    run's distance from fp64 (relative norm), or within 1e-5; where a
    max-pool of the card's forward picked another winner than fp64's
    (C.13), within 1e-2 of fp64."""
    n = IMAGES["check_batch"]
    x = data.train.normalize(torch.as_tensor(
        np.asarray(data.train.clips[::len(data.train) // n][:n])))
    y = torch.as_tensor(data.train.labels[::len(data.train) // n][:n]).long()
    runs_on = (("fp64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
               ("card", "cuda", torch.float32))
    rows = {}
    for name in IMAGE_STEP_NETS:
        runs, logs = {}, {}
        for key, dev, dt in runs_on:
            net = _image_net(name, dev, dt)
            params = {k: v.detach().requires_grad_(True)
                      for k, v in net.named_parameters()}
            with image_pool_log(logs.setdefault(key, [])):
                logits = torch.func.functional_call(
                    net, params, (x.to(dev, dt),), dict(train=True))
            loss = torch.nn.functional.cross_entropy(logits, y.to(dev))
            grads = torch.autograd.grad(loss, list(params.values()))
            runs[key] = (loss.reshape(1),
                         torch.cat([g.reshape(-1) for g in grads]))
        dist = {key: {k: _rel(t, r) for k, t, r in zip(
            ("loss", "grad"), runs[key], runs["fp64"])}
            for key in ("cpu", "card")}
        flipped = {key: flips(logs[key], logs["fp64"], ("max_pool",))
                   for key in ("cpu", "card")}
        for k, v in dist["card"].items():
            cap = (MTT_FP64_CAP if flipped["card"]
                   else max(3 * dist["cpu"][k], 1e-5))
            assert v <= cap, (f"{name} card vs CPU: {k} {v} from fp64, over "
                              f"{cap} (CPU {dist['cpu'][k]}, flips {flipped})")
        rows[name] = {"rel_norm_vs_fp64": dist, "max_pool_flips": flipped}
    for name in IMAGE_BN_NETS:
        runs = {}
        for key, dev, dt in runs_on:
            net = _image_net(name, dev, dt)
            with torch.no_grad():
                out = net(x.to(dev, dt), train=True)
                stats = torch.cat([b.reshape(-1) for b in net.buffers()])
                runs[key] = (out, stats, net(x.to(dev, dt), train=False))
        dist = {key: {k: _rel(t, r) for k, t, r in zip(
            ("train_out", "running_stats", "eval_out"), runs[key],
            runs["fp64"])} for key in ("cpu", "card")}
        for k, v in dist["card"].items():
            cap = max(3 * dist["cpu"][k], 1e-5)
            assert v <= cap, f"{name} BatchNorm card vs CPU: {k} {v} > {cap}"
        rows[name] = {"rel_norm_vs_fp64": dist}
    emit({"phase": "images_card_vs_cpu", "nets": rows, "ok": True})


def images_zca(data):
    """ZCA fitted on the host on the 50,000 normalised training images (a
    3072^2 covariance, fp64), applied and inverted on the card: the round
    trip within 1e-3 (JAX tests/test_ops_extra.py:14-23), the card's
    whitening of 1,000 images within 1e-5 of the CPU's (of the largest
    |value|)."""
    meta = data.meta
    mean = np.asarray(meta.mean, np.float32)
    std = np.asarray(meta.std, np.float32)
    x = ((data.train.clips.astype(np.float32) / 255.0 - mean) / std).astype(
        np.float32)
    t0 = time.perf_counter()
    state = zca.fit_zca(x, reg=0.1)
    fit_s = time.perf_counter() - t0
    xd = torch.from_numpy(x).cuda()
    apply_s, w = _synced_seconds(lambda: zca.apply_zca(state, xd))
    invert_s, back = _synced_seconds(lambda: zca.invert_zca(state, w))
    round_trip = float((back - xd).abs().max())
    assert round_trip <= 1e-3, round_trip
    w_cpu = zca.apply_zca(state, torch.from_numpy(x[:1000]))
    card_vs_cpu = float((w[:1000].cpu() - w_cpu).abs().max()
                        / w_cpu.abs().max())
    assert card_vs_cpu <= 1e-5, card_vs_cpu
    emit({"phase": "images_zca", "images": int(x.shape[0]),
          "fit_seconds_host": fit_s, "apply_ms": apply_s * 1e3,
          "invert_ms": invert_s * 1e3, "round_trip_max_abs": round_trip,
          "card_vs_cpu": card_vs_cpu, "ok": True})


def phase_images(tmp):
    """The image side at CIFAR10's size (IMAGES): the store, the coreset
    driver's pool 'M', raw DM, raw FRePo, the card against the CPU, ZCA."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    data_path = image_store(tmp)
    data = load_packed(os.path.join(data_path,
                                    f"{IMAGES['dataset']}_packed"))
    emit({"phase": "images_store", "seconds": time.perf_counter() - t0,
          "train": data.train.clips.shape, "test": data.test.frames.shape,
          "mb": (data.train.clips.nbytes + data.test.frames.nbytes) / 1e6})
    images_coreset(data_path, data)
    images_dm(data_path, tmp)
    images_frepo(data)
    check_images_card_vs_cpu(data)
    images_zca(data)
    emit({"phase": "images", "seconds": time.perf_counter() - t0,
          "ok": True})


def phase_expert():
    """One epoch of expert training in bf16 against fp32 on the same
    inputs, then the time of a bf16 expert step at the preset's batch."""
    bcfg = BufferConfig(dataset=EXPERT["dataset"], train_epochs=1,
                        batch_train=EXPERT["batch"], frames=16, device="cuda")
    data = load_data(bcfg)
    store, meta = data.train, data.meta
    nb = -(-len(store) // EXPERT["batch"])
    _, theta0 = flat_param_template(
        bcfg.model, meta.channel, meta.num_classes, tuple(meta.im_size),
        meta.frames, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    draws = ExpertDraws(theta0.cpu().numpy(),
                        [[rng.random(EXPERT["batch"]) < 0.5
                          for _ in range(nb)]])
    masks = [[torch.from_numpy(rng.random((EXPERT["batch"], 1, 1, 1, 128))
                               < 0.5).cuda() for _ in range(nb)]]
    rounded = ExpertDraws(theta0.bfloat16().float().cpu().numpy(),
                          draws.flips)
    moves = {}
    for name, dt, d in (("fp32", "float32", draws), ("bf16", "bfloat16", draws),
                        ("fp32_rounded_init", "float32", rounded)):
        traj, _ = train_expert(
            None, store, dataclasses.replace(bcfg, compute_dtype=dt),
            np.random.default_rng(1), "cuda", d, masks)
        moves[name] = traj[1].astype(np.float64) - traj[0]
    ref = moves["fp32"]
    rel = {k: float(np.linalg.norm(moves[k] - ref) / np.linalg.norm(ref))
           for k in ("bf16", "fp32_rounded_init")}
    tol = EXPERT_BF16_FACTOR * rel["fp32_rounded_init"]
    assert rel["bf16"] <= tol, (f"expert: bf16 parameter change off by "
                                f"{rel['bf16']} (rel norm) from fp32, over "
                                f"{tol}")

    timed = dataclasses.replace(bcfg, train_epochs=EXPERT["timed_epochs"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_first_stage()
    epochs_s, _ = _synced_seconds(lambda: train_expert(
        gen, store, timed, np.random.default_rng(0), "cuda"))
    first_stage = check_first_stage_counts(
        "expert", first_order(EXPERT["timed_epochs"] * nb))
    emit({"phase": "expert", "dataset": EXPERT["dataset"],
          "batch": EXPERT["batch"], "steps_per_epoch": nb,
          "rel_norm_err_vs_fp32": rel, "tolerance": tol,
          "ms_per_expert_epoch_bf16": epochs_s / EXPERT["timed_epochs"] * 1e3,
          "ms_per_expert_step_bf16":
              epochs_s / (EXPERT["timed_epochs"] * nb) * 1e3,
          "first_stage_launches": first_stage, "ok": True})


def _timed(fn, seconds):
    """``fn`` with each call's synced host time appended to ``seconds``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def check_dc_card_vs_cpu():
    """One DC matching step and one inner_train (50 SGD steps) from the
    same parameters, images and real batch: fp32 (TF32 off) on the card
    and on the CPU, each against an fp64 CPU run. The step is sensitive
    (the cosine of small gradient rows; inner_train compounds it), so the
    yardstick is the CPU fp32 run's own distance from fp64: the card's
    loss, image update and trained parameters each within 3x of it
    (relative norm), or within 1e-6."""
    data = make_synthetic_video_data(**DC_SMALL)
    store = distill_static.to_single_frame_store(data.train,
                                                 np.random.default_rng(0))
    rng = np.random.default_rng(1)
    ipc, n = 10, DC_SMALL["num_classes"] * 10
    syn = torch.from_numpy(rng.normal(size=(n, 32, 32, 3)).astype(np.float32))
    mom = torch.from_numpy(rng.normal(size=syn.shape).astype(np.float32)) * 0.1
    labels = torch.arange(DC_SMALL["num_classes"]).repeat_interleave(ipc)
    idx = torch.from_numpy(store.sample_per_class(rng, 16))
    trainers = {dev: dc.make_dc_trainer(store, "ConvNet", ipc, 16, 0.1, 0.01,
                                        device=dev) for dev in ("cpu", "cuda")}
    params = trainers["cpu"].fresh_net(torch.Generator().manual_seed(2))
    runs = {}
    for dev, dt in (("cpu", torch.float64), ("cpu", torch.float32),
                    ("cuda", torch.float32)):
        tr = trainers[dev]
        on = lambda t: t.to(dev, dt)
        p0 = {k: on(v) for k, v in params.items()}
        _, m2, loss = tr.match_step(p0, on(syn), on(mom), idx.to(dev))
        zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
        p2, _ = tr.inner_train(p0, zeros, on(syn), labels.to(dev))
        runs[dev, dt] = (loss.reshape(1), m2 - 0.5 * on(mom),
                         torch.cat([v.reshape(-1) for v in p2.values()]))
    ref = [t.double() for t in runs["cpu", torch.float64]]
    dist = {dev: {k: float((t.cpu().double() - r).norm() / r.norm())
                  for k, t, r in zip(("loss", "update", "inner_train_params"),
                                     runs[dev, torch.float32], ref)}
            for dev in ("cpu", "cuda")}
    for k, v in dist["cuda"].items():
        assert v <= max(3 * dist["cpu"][k], 1e-6), (
            f"DC card vs CPU: {k} {v} from fp64 on the card, over 3x the "
            f"CPU's {dist['cpu'][k]}")
    emit({"phase": "static_card_vs_cpu", "rel_norm_vs_fp64": dist,
          "ok": True})


def packed_synthetic(tmp, synthetic, dataset, folder):
    """``make_synthetic_video_data`` at the sizes ``synthetic`` names,
    written with ``save_packed`` as ``dataset`` under ``tmp/folder``.
    Returns the data path."""
    data = make_synthetic_video_data(
        name=dataset, **synthetic_kwargs_from_name(synthetic))
    data_path = os.path.join(tmp, folder)
    save_packed(os.path.join(data_path, f"{dataset}_packed"), data)
    return data_path


def phase_static(tmp):
    """Static learning (DC) through ``drivers.distill_static.main`` at full
    width, from a store written with ``save_packed``; then its checks,
    times and peak memory, and the card against the CPU at a small size."""
    c = STATIC
    data_path = packed_synthetic(tmp, c["synthetic"], c["dataset"],
                                 "static_data")
    times = {"match": [], "inner": [], "iteration": []}
    losses = []
    saved = {k: getattr(dc.DCTrainer, k)
             for k in ("match_step", "inner_train", "__call__")}

    def iteration(self, *args):
        out = saved["__call__"](self, *args)
        losses.append(out[2])
        return out

    dc.DCTrainer.match_step = _timed(saved["match_step"], times["match"])
    dc.DCTrainer.inner_train = _timed(saved["inner_train"], times["inner"])
    dc.DCTrainer.__call__ = _timed(iteration, times["iteration"])
    logger = RecordingLogger()
    torch.cuda.reset_peak_memory_stats()
    try:
        run_s, path = _synced_seconds(lambda: distill_static.main([
            "--dataset", c["dataset"], "--data_path", data_path, "--model",
            c["model"], "--spc", str(c["spc"]), "--batch_real",
            str(c["batch_real"]), "--Iteration", str(c["iteration"]),
            "--save_path", os.path.join(tmp, "static_out"), "--seed",
            str(c["seed"]), "--device", "cuda"], logger=logger))
    finally:
        for k, fn in saved.items():
            setattr(dc.DCTrainer, k, fn)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    static = np.load(path)
    n_cls = synthetic_kwargs_from_name(c["synthetic"])["num_classes"]
    assert static.shape == (n_cls * c["spc"], 112, 112, 3), static.shape
    assert static.dtype == np.float32 and np.isfinite(static).all()
    # distill_static's 'real' initialisation, drawn again from the same seed
    rng = np.random.default_rng(c["seed"])
    singles = distill_static.to_single_frame_store(
        load_packed(os.path.join(data_path, f"{c['dataset']}_packed")).train, rng)
    init, _ = init_synthetic_raw(None, singles, c["spc"], 1, "real", rng,
                                 device="cpu")
    moved = float(np.abs(static - init.numpy()[:, 0]).max())
    assert moved > 0, "static: the learned images equal their init"
    logged = [m["Loss"] for _, m in logger.records]
    assert logged and all(np.isfinite(logged)), logged
    assert len(losses) == c["iteration"] + 1 and all(np.isfinite(losses))
    outer, inner = dc.get_loops(c["spc"])
    assert len(times["match"]) == outer * len(losses)
    assert len(times["inner"]) == (outer - 1) * len(losses)
    emit({"phase": "static", "dataset": c["synthetic"], "model": c["model"],
          "spc": c["spc"], "batch_real": c["batch_real"],
          "iterations": len(losses), "outer_loop": outer,
          "inner_loop": inner, "driver_seconds": run_s,
          "ms_per_matching_step": float(np.mean(times["match"])) * 1e3,
          "ms_per_inner_step": float(np.mean(times["inner"])) / inner * 1e3,
          "seconds_per_dc_iteration": times["iteration"],
          "mean_matching_loss": losses, "logged_loss": logged,
          "max_abs_change_from_init": moved,
          "max_memory_allocated_gb": peak_gb, "ok": True})
    check_dc_card_vs_cpu()


# the baselines at full width: miniUCF101's 50 classes, 64 train clips of
# 16 frames at 112x112 a class (batch_real=64 draws distinct ones; 1.93 GB
# of uint8), one test video of 40 frames a class; the DM, s2d_DM_ms and MTT
# presets and the coreset driver's defaults, evaluation cut to one net of
# 10 epochs (the presets: 3-5 nets of 500, the coreset driver 5 of 1000)
BASELINES = dict(synthetic="synthetic_c50_n64_t1_f16_im112",
                 dataset="baselinesmoke_c50_n64_t1_f16_im112",
                 num_classes=50, frames=16, im=112, dm_iterations=3,
                 mtt_iterations=3, num_eval=1, epoch_eval_train=10, seed=0)
# an fp32 step whose maxes picked another winner than fp64's somewhere
# stays within this of fp64
MTT_FP64_CAP = 1e-2
# ROADMAP C.13: an fp32 step whose forward picks the same winner in every
# max (the phase max, the later max-pools) as the fp64 step stays within
# FP64_NO_TIE of it (relative norm); one that picks another winner
# somewhere (a "flip": a near tie that fp32 rounding decides the other way)
# stays within MTT_FP64_CAP; the raw MTT check holds MTT_DRAWS draws
# (PERF.md section 7: the strays are exactly the runs with a flip; near
# ties counted by margin do not find them, flips happen at up to 21 ulps)
FP64_NO_TIE = 1e-5
MTT_DRAWS = 9
# the card against the CPU: ConvNet3D at 3 classes, 64x64x8
BASELINES_SMALL = dict(num_classes=3, clips_per_class=6, test_per_class=1,
                       frames=8, im_size=(64, 64), name="baselines-card-vs-cpu")


@contextlib.contextmanager
def routing_log(log):
    """Append every routing decision of the ConvNet3Ds built and run inside
    the block to ``log``, in call order: each phase max's winners (and each
    window's margin over its runner-up, in fp32 ulps of the winner), each
    later max-pool's argmax and each activation's sign mask, all on the
    CPU. Their gradients follow these decisions, so two runs that decide
    alike differ only by rounding."""
    orig = (pt.phase_argmax, convnet3d.max_pool, convnet3d.activation)

    def phase(y, rows_per_batch):
        m, idx = orig[0](y, rows_per_batch)
        top = y.detach().float().view(y.shape[0], 4, -1).topk(2, dim=1).values
        win = top[:, 0].abs()
        ulp = torch.nextafter(win, torch.full_like(win, float("inf"))) - win
        log.append({"kind": "phase_max", "idx": idx.cpu(),
                    "margin_ulps": ((top[:, 0] - top[:, 1]) / ulp).cpu()})
        return m, idx

    def pool(x, window, strides=None):
        _, idx = torch.nn.functional.max_pool3d(
            x.detach(), tuple(window), stride=tuple(strides or window),
            return_indices=True)
        log.append({"kind": "max_pool", "idx": idx.cpu()})
        return orig[1](x, window, strides)

    def activation(name):
        act = orig[2](name)

        def record(x):
            log.append({"kind": "activation", "idx": (x.detach() > 0).cpu()})
            return act(x)
        return record

    pt.phase_argmax, convnet3d.max_pool, convnet3d.activation = (
        phase, pool, activation)
    try:
        yield log
    finally:
        pt.phase_argmax, convnet3d.max_pool, convnet3d.activation = orig


def near_ties(log, ulps):
    """Phase-max windows of ``log`` whose winner is within ``ulps`` fp32
    ulps of its runner-up."""
    return int(sum(int((c["margin_ulps"] <= ulps).sum()) for c in log
                   if c["kind"] == "phase_max"))


def flips(log, ref, kinds=("phase_max", "max_pool")):
    """Routing decisions of ``log`` of the ``kinds`` (by default the maxes,
    which route a gradient to one candidate) that differ from ``ref``'s,
    call by call."""
    assert [c["kind"] for c in log] == [c["kind"] for c in ref]
    return int(sum(int((a["idx"] != b["idx"]).sum()) for a, b in zip(log, ref)
                   if a["kind"] in kinds))


def routing_report(logs, ref_key, thresholds=(1, 4, 16, 64, 256)):
    """Per run of ``logs``: the phase max's near ties at each threshold and
    smallest margin in ulps, and the decisions of each kind that differ
    from run ``ref_key``'s."""
    return {str(k): {"phase_max_near_ties": {u: near_ties(v, u)
                                             for u in thresholds},
                     "phase_max_min_margin_ulps": min(
                         (float(c["margin_ulps"].min()) for c in v
                          if c["kind"] == "phase_max"), default=None),
                     "flips_vs_" + str(ref_key): {
                         kind: flips(v, logs[ref_key], (kind,))
                         for kind in ("phase_max", "max_pool", "activation")}}
            for k, v in logs.items()}


def dm_step_launches(real_chunks):
    """First-stage launches of one DM step: the synthetic forward and each
    real chunk's pack and take the phase max; the backward into the
    synthetic set scatters and unpacks once; nothing selects."""
    return {"phase_argmax": 1 + real_chunks, "phase_select": 0,
            "phase_scatter": 1, "s2d2_pack": 1 + real_chunks,
            "s2d2_unpack": 1}


@contextlib.contextmanager
def checked_steps(cls, check, seconds):
    """Every call of ``cls.__call__`` (a training step) runs with the
    kernels' launch counts set to 0 just before it; its synced host time is
    appended to ``seconds`` and ``check(out)`` reads its output and the
    counts just after it."""
    orig = cls.__call__

    def call(self, *args, **kwargs):
        reset_first_stage()
        hc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, *args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        check(out)
        return out

    cls.__call__ = call
    try:
        yield
    finally:
        cls.__call__ = orig


def _check_hal_launches(where, want):
    if dict(hc.LAUNCHES) != want:
        raise AssertionError(f"{where}: hal_conv launches {dict(hc.LAUNCHES)}, "
                             f"expected {want}")


def _common_argv(data_path, out, iterations, evaluate):
    """Flags shared by the baseline runs: the store, the cut evaluation
    (at iteration 0 only, or none), the card."""
    c = BASELINES
    return ["--dataset", c["dataset"], "--data_path", data_path,
            "--save_path", out, "--Iteration", str(iterations),
            "--startIt", "0" if evaluate else str(iterations + 1),
            "--eval_it", "1000", "--num_eval", str(c["num_eval"]),
            "--epoch_eval_train", str(c["epoch_eval_train"]),
            "--seed", str(c["seed"]), "--device", "cuda"]


def baselines_dm(data_path, tmp, store):
    """Raw DM through ``distill_baseline.main`` (the DM preset, fp32): 1
    warm-up + timed steps, each checked; then one bf16 step."""
    c = BASELINES
    chunks = -(-c["num_classes"] * 64 // dm.REAL_CHUNK)  # batch_real=64
    want = dm_step_launches(chunks)
    res = {}
    for dtype, iterations in (("float32", c["dm_iterations"]),
                              ("bfloat16", 0)):
        steps, real, losses = [], [], []

        def check(out):
            state, loss = out
            losses.append(float(loss))
            if not (np.isfinite(losses[-1]) and _finite(state.syn_images)):
                raise AssertionError(f"DM {dtype}: non-finite loss or images")
            check_first_stage_counts(f"DM {dtype} step", want)
            _check_hal_launches(f"DM {dtype} step", {k: 0 for k in hc.LAUNCHES})

        out_dir = os.path.join(tmp, f"baselines_dm_{dtype}")
        saved = dm._DMTrainerBase.real_feats
        dm._DMTrainerBase.real_feats = _timed(saved, real)
        torch.cuda.reset_peak_memory_stats()
        try:
            with checked_steps(dm.DMTrainer, check, steps):
                run_s, state = _synced_seconds(lambda: distill_baseline.main(
                    ["--preset", "DM", "--compute_dtype", dtype,
                     *_common_argv(data_path, out_dir, iterations,
                                   dtype == "float32")],
                    logger=MetricLogger(quiet=True)))
        finally:
            dm._DMTrainerBase.real_feats = saved
        init, _ = init_synthetic_raw(None, store, 1, c["frames"], "real",
                                     np.random.default_rng(c["seed"]), "cuda")
        moved = float((state.syn_images - init).abs().max())
        assert moved > 0, f"DM {dtype}: the images equal their init"
        row = {"driver_seconds": run_s, "steps": len(steps),
               "losses": losses, "max_abs_change_from_init": moved,
               "real_chunks": chunks, "launches_per_step": want,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 2 ** 30}
        timed = slice(1, None) if len(steps) > 1 else slice(None)
        row["ms_per_step"] = float(np.mean(steps[timed])) * 1e3
        row["ms_real_embed"] = float(np.mean(real[timed])) * 1e3
        row["ms_synthetic_fwd_bwd_update"] = row["ms_per_step"] - row["ms_real_embed"]
        if dtype == "float32":
            out = os.path.join(out_dir, f"Baseline_DM_{c['dataset']}")
            img = np.load(os.path.join(out, "images_0.npy"))
            assert img.shape == tuple(init.shape) and np.isfinite(img).all()
            assert os.path.exists(os.path.join(out, "png", "videos_000000.png"))
        res[dtype] = row
    emit({"phase": "baselines_dm", **res, "ok": True})
    return res


def baselines_s2d_dm(data_path, tmp):
    """S2D-DM through ``distill_s2d.run`` (``s2d_DM_ms``, fp32): each step
    launches the three hal_conv kernels once and the first stage as a DM
    step does; the evaluation launches hal_fused once a training step."""
    c = BASELINES
    chunks = -(-c["num_classes"] * 64 // dm.REAL_CHUNK)
    want = dm_step_launches(chunks)
    cfg = get_preset("s2d_DM_ms")
    cfg.s2d = True
    cfg.dataset, cfg.data_path = c["dataset"], data_path
    cfg.save_path = os.path.join(tmp, "baselines_s2d_dm")
    cfg.Iteration, cfg.startIt, cfg.eval_it = c["dm_iterations"], 0, 1000
    cfg.num_eval, cfg.epoch_eval_train = c["num_eval"], c["epoch_eval_train"]
    cfg.seed, cfg.device = c["seed"], "cuda"
    data = load_data(cfg)
    steps, real, losses = [], [], []

    def check(out):
        losses.append(float(out[2]))
        if not np.isfinite(losses[-1]):
            raise AssertionError("S2D-DM: non-finite loss")
        check_first_stage_counts("S2D-DM step", want)
        _check_hal_launches("S2D-DM step", {k: 1 for k in hc.LAUNCHES})

    saved = dm._DMTrainerBase.real_feats
    dm._DMTrainerBase.real_feats = _timed(saved, real)
    torch.cuda.reset_peak_memory_stats()
    hf.reset_launches()
    try:
        with checked_steps(dm.S2DDMTrainer, check, steps):
            run_s, holder = _synced_seconds(
                lambda: run(cfg, data, MetricLogger(quiet=True)))
    finally:
        dm._DMTrainerBase.real_feats = saved
    expect = (cfg.epoch_eval_train + 1) * cfg.num_eval
    assert hf.LAUNCHES["hal_fused"] == expect, (
        f"S2D-DM: hal_fused launched {hf.LAUNCHES['hal_fused']}, {expect} "
        "expected")
    fresh = build_s2d(cfg, data.meta, "cuda")[1]
    st = holder["state"]
    moved = {"dynamic": float((st["dynamic"] - fresh["dynamic"]).abs().max()),
             "hal": float((st["hals"][0]["weight"]
                           - fresh["hals"][0]["weight"]).abs().max())}
    assert all(v > 0 for v in moved.values()), moved
    assert torch.equal(st["static"], fresh["static"])  # frozen
    assert all(_finite(t) for t in (st["dynamic"], st["hals"][0]["weight"]))
    row = {"phase": "baselines_s2d_dm", "driver_seconds": run_s,
           "steps": len(steps), "losses": losses,
           "ms_per_step": float(np.mean(steps[1:])) * 1e3,
           "ms_real_embed": float(np.mean(real[1:])) * 1e3,
           "max_abs_change": moved, "hal_fused_launches": expect,
           "launches_per_step": {**want, **{k: 1 for k in hc.LAUNCHES}},
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 2 ** 30, "ok": True}
    row["ms_synthetic_fwd_bwd_update"] = row["ms_per_step"] - row["ms_real_embed"]
    emit(row)
    return row


# ROADMAP C.12: S2D-DM at the rate that learns in the JAX package's records
# (BASELINE.md:107-113, test_s2d_dm_step_runs_and_learns), beside the
# preset's 1e-2; the loss of one fixed probe net and real batch must fall
S2D_DM_LEARN = dict(lr=1e-4, steps=10, probe_stream=30_000_000)


def baselines_s2d_dm_learns(data_path):
    """S2D-DM through ``distill_s2d.run`` (``s2d_DM_ms``, fp32) at
    lr_dynamic = lr_hal = 1e-4 for 10 steps, without evaluation: every loss
    finite, and the probe loss (a fixed net and real batch, before any
    update) of the final state below the initial state's."""
    c, L = BASELINES, S2D_DM_LEARN
    cfg = get_preset("s2d_DM_ms")
    cfg.s2d = True
    cfg.dataset, cfg.data_path = c["dataset"], data_path
    cfg.lr_dynamic = cfg.lr_hal = L["lr"]
    cfg.Iteration = L["steps"] - 1
    cfg.startIt = cfg.Iteration + 1  # no evaluation
    cfg.seed, cfg.device = c["seed"], "cuda"
    data = load_data(cfg)
    losses = []
    run_s, holder = _synced_seconds(lambda: run(
        cfg, data, MetricLogger(quiet=True),
        step_hook=lambda it, out: losses.append(float(out[2]))))
    s2d_cfg, fresh = build_s2d(cfg, data.meta, "cuda")
    probe_tr = dm.make_s2d_dm_trainer(
        data.train, cfg.model, s2d_cfg, cfg.batch_real, cfg.lr_static,
        cfg.lr_dynamic, cfg.lr_hal, not cfg.no_train_static, cfg.frames,
        device="cuda")

    def probe(st):
        gen = step_generator(cfg.seed, L["probe_stream"], "cuda")
        return float(probe_tr(gen, st, init_s2d_momentum(st),
                              np.random.default_rng(1))[2])

    before, after = probe(fresh), probe(holder["state"])
    row = {"phase": "baselines_s2d_dm_learns", "lr": L["lr"],
           "steps": len(losses), "losses": losses,
           "probe_loss_before": before, "probe_loss_after": after,
           "driver_seconds": run_s}
    emit(row)
    assert np.isfinite(losses).all() and np.isfinite([before, after]).all()
    assert after < before, f"S2D-DM at {L['lr']}: probe loss {before} -> {after}"
    emit({"phase": "baselines_s2d_dm_learns", "ok": True})
    return row


def baselines_mtt(data_path, tmp):
    """Raw MTT through ``distill_baseline.main`` (the MTT preset) from a
    fabricated two-snapshot buffer: 1 warm-up + 3 timed steps in bf16 with
    the fp32 head, then one fp32 step."""
    c = BASELINES
    nc, f, im = c["num_classes"], c["frames"], c["im"]
    buf = os.path.join(tmp, "baselines_buffer")
    os.makedirs(buf, exist_ok=True)
    thetas = [flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                  torch.Generator(device="cuda").manual_seed(s),
                                  "cuda")[1].cpu().numpy() for s in (0, 1)]
    TrajectoryBuffer(np.stack(thetas)[None]).save(
        os.path.join(buf, "replay_buffer_0.npz"))
    syn_steps = get_preset("MTT").syn_steps
    want = per_outer_step(syn_steps)
    res = {}
    for dtype, iterations in (("bfloat16", c["mtt_iterations"]),
                              ("float32", 0)):
        steps, losses = [], []

        def check(out):
            losses.append(float(out[4]))
            grads = out[7]
            bad = [k for k, v in grads.items() if not _finite(v)]
            if bad or not np.isfinite(losses[-1]):
                raise AssertionError(f"MTT {dtype}: non-finite {bad or 'loss'}")
            if not float(out[1]) >= 0.001:
                raise AssertionError(f"MTT {dtype}: syn_lr {float(out[1])}")
            check_first_stage_counts(f"MTT {dtype} step", want)

        torch.cuda.reset_peak_memory_stats()
        with checked_steps(MTTStep, check, steps):
            run_s, _ = _synced_seconds(lambda: distill_baseline.main(
                ["--preset", "MTT", "--buffer_path", buf, "--max_start_epoch",
                 "1", "--compute_dtype", dtype,
                 *_common_argv(data_path, os.path.join(tmp, f"baselines_mtt_{dtype}"),
                               iterations, dtype == "bfloat16")],
                logger=MetricLogger(quiet=True)))
        row = {"driver_seconds": run_s, "steps": len(steps),
               "step_seconds": steps, "grand_loss": losses,
               "syn_steps": syn_steps, "launches_per_step": want,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 2 ** 30}
        if len(steps) > 1:
            row["steps_per_sec"] = (len(steps) - 1) / sum(steps[1:])
        res[dtype] = row
    emit({"phase": "baselines_mtt", **res, "ok": True})
    return res


def baselines_coresets(data_path, store):
    """k-center and herding through ``distill_coreset.main``: every chosen
    clip is a clip of its label's class; ms per embed chunk of 64 clips."""
    c = BASELINES
    res = {}
    for method in ("k-center", "herding"):
        chunk_s, select_s = [], []
        saved = (coreset.real_features, distill_coreset.select_coreset)
        coreset.real_features = _timed(saved[0], chunk_s)

        def select(*args, **kwargs):
            reset_first_stage()
            out = _timed(saved[1], select_s)(*args, **kwargs)
            # one no-grad forward a chunk, and each class is one chunk
            check_first_stage_counts(f"coreset {method}",
                                     first_order(0, c["num_classes"]))
            return out

        distill_coreset.select_coreset = select
        try:
            run_s, (syn, labels, accs) = _synced_seconds(
                lambda: distill_coreset.main(
                    ["--dataset", c["dataset"], "--data_path", data_path,
                     "--method", method, "--num_eval", str(c["num_eval"]),
                     "--epoch_eval_train", str(c["epoch_eval_train"]),
                     "--device", "cuda"], logger=MetricLogger(quiet=True)))
        finally:
            coreset.real_features, distill_coreset.select_coreset = saved
        assert labels.tolist() == list(range(c["num_classes"]))
        for v, k in zip(syn, labels.tolist()):
            idx = np.nonzero(store.labels == k)[0]
            clips = store.normalize(torch.as_tensor(
                np.asarray(store.clips[idx]), device="cuda"))
            if not any(torch.equal(v, r) for r in clips):
                raise AssertionError(f"coreset {method}: a clip of class {k} "
                                     "is not from that class")
        (acc, _), = accs.values()
        assert np.isfinite(acc) and 0.0 <= acc <= 1.0, acc
        res[method] = {"driver_seconds": run_s,
                       "selection_seconds": select_s[0],
                       "ms_per_embed_chunk_of_64":
                           float(np.mean(chunk_s[1:])) * 1e3,
                       "chunks": len(chunk_s), "accuracy": acc}
    emit({"phase": "baselines_coresets", **res, "ok": True})
    return res


def _rel(a, ref):
    a, ref = a.detach().cpu().double(), ref.detach().cpu().double()
    return float((a - ref).norm() / ref.norm())


def check_baselines_card_vs_cpu():
    """One raw DM step, one S2D-DM step and one raw MTT step, fp32, at 3
    classes, 64x64x8, from the same inputs, net and draws: the kernels on
    the card, the plain versions on the CPU. DM: loss within 1e-5
    relative, gradients and updates within 1e-4 relative norm. MTT: see
    below."""
    c = BASELINES_SMALL
    store = make_synthetic_video_data(**c).train
    nc, f, im = c["num_classes"], c["frames"], c["im_size"][0]
    gen = torch.Generator().manual_seed(0)
    syn = torch.randn(nc, f, im, im, 3, generator=gen)
    out = {}

    def on(dev, tree):
        if isinstance(tree, dict):
            return {k: on(dev, v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [on(dev, v) for v in tree]
        return tree.to(dev)

    # raw DM
    runs = {}
    params = None
    for dev in ("cpu", "cuda"):
        tr = dm.make_dm_trainer(store, "ConvNet3D", 1, 4, 1.0, f, device=dev)
        params = params or tr.fresh_net(torch.Generator().manual_seed(1))
        tr.fresh_net = lambda g, p=on(dev, params): p
        state, loss = tr(None, dm.DMState(syn.to(dev), torch.arange(nc, device=dev),
                                          torch.zeros_like(syn, device=dev)),
                         np.random.default_rng(2))
        runs[dev] = (loss, state.momentum, state.syn_images)
    out["dm"] = {"loss": abs(float(runs["cuda"][0]) / float(runs["cpu"][0]) - 1),
                 "grad": _rel(runs["cuda"][1], runs["cpu"][1]),
                 "images": _rel(runs["cuda"][2], runs["cpu"][2])}

    # S2D-DM, frozen static
    s2d_cfg = S2DConfig(num_classes=nc, frames=f, im_size=(im, im))
    state0 = init_s2d_state(torch.Generator().manual_seed(3), s2d_cfg, "cpu")
    draws = torch.randint(0, 2, (2, nc), generator=gen)
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = dm.make_s2d_dm_trainer(store, "ConvNet3D", s2d_cfg, 4, 100.0,
                                    0.01, 0.01, False, f, device=dev)
        tr.fresh_net = lambda g, p=on(dev, params): p
        st = on(dev, state0)
        runs[dev] = tr(None, st, init_s2d_momentum(st),
                       np.random.default_rng(2), draws=draws.to(dev))
    cu, cp = runs["cuda"], runs["cpu"]
    out["s2d_dm"] = {
        "loss": abs(float(cu[2]) / float(cp[2]) - 1),
        "grad_dynamic": _rel(cu[1]["dynamic"], cp[1]["dynamic"]),
        "grad_hal_weight": _rel(cu[1]["hals"][0]["weight"], cp[1]["hals"][0]["weight"]),
        "grad_hal_bias": _rel(cu[1]["hals"][0]["bias"], cp[1]["hals"][0]["bias"]),
        "dynamic": _rel(cu[0]["dynamic"], cp[0]["dynamic"]),
        "hal_weight": _rel(cu[0]["hals"][0]["weight"], cp[0]["hals"][0]["weight"])}
    for name in ("dm", "s2d_dm"):
        for k, v in out[name].items():
            tol = 1e-5 if k == "loss" else 1e-4
            assert v <= tol, f"{name} card vs CPU: {k} off by {v} > {tol}"

    # raw MTT over MTT_DRAWS draws, each device against an fp64 CPU step:
    # a max routes a gradient to whichever of two near-equal candidates fp32
    # rounding makes larger, so a device may stray where its winner differs
    # from fp64's (ROADMAP C.13, PERF.md section 7)
    out["mtt"] = [mtt_card_vs_cpu(*mtt_draw(seed)) for seed in range(MTT_DRAWS)]
    for m in out["mtt"]:
        del m["routing"]
    emit({"phase": "baselines_card_vs_cpu", "rel_err": out})
    for m in out["mtt"]:
        check_mtt_draw(m)
    emit({"phase": "baselines_card_vs_cpu", "ok": True})


def mtt_card_vs_cpu(syn, gen):
    """One raw MTT step (syn_steps=2) fp32 on the card and on the CPU and
    fp64 on the CPU, from the same inputs, plan and dropout masks: the
    relative distances of loss and outer gradients, card against CPU and
    each fp32 device against fp64; each fp32 device's max winners that
    differ from fp64's (``flips_vs_fp64``) and the ``routing_report``."""
    c = BASELINES_SMALL
    nc, f, im = c["num_classes"], c["frames"], c["im_size"][0]
    steps = 2
    _, t0 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator().manual_seed(4), "cpu")
    _, t1 = flat_param_template("ConvNet3D", 3, nc, (im, im), f,
                                torch.Generator().manual_seed(5), "cpu")
    plan = torch.as_tensor(make_batch_plan(np.random.default_rng(6), nc, nc,
                                           steps))
    masks = torch.rand(steps, nc, 1, 1, 1, 128, generator=gen) < 0.5
    runs, logs = {}, {}
    for dev, dtype in (("cpu", "float64"), ("cpu", "float32"),
                       ("cuda", "float32")):
        dt = getattr(torch, dtype)
        with routing_log(logs.setdefault(f"{dev}_{dtype}", [])):
            step = MTTStep("ConvNet3D", 3, nc, (im, im), f, steps, 100.0,
                           1e-5, True, dtype, dev)
            runs[dev, dtype] = step(
                None, syn.to(dev, dt), torch.arange(nc, device=dev),
                torch.tensor(0.01, device=dev),
                torch.zeros_like(syn, device=dev, dtype=dt),
                torch.zeros((), device=dev), t0.to(dev, dt), t1.to(dev, dt),
                plan.to(dev), keep_masks=masks.to(dev))

    def dist(a, b):
        return {"loss": abs(float(a[4]) / float(b[4]) - 1),
                "grad_images": _rel(a[7]["images"], b[7]["images"]),
                "grad_syn_lr": _rel(a[7]["syn_lr"], b[7]["syn_lr"])}

    cu, cp, f64 = (runs["cuda", "float32"], runs["cpu", "float32"],
                   runs["cpu", "float64"])
    return {"card_vs_cpu": dist(cu, cp), "card_vs_fp64": dist(cu, f64),
            "cpu_vs_fp64": dist(cp, f64),
            "flips_vs_fp64": {"card": flips(logs["cuda_float32"],
                                            logs["cpu_float64"]),
                              "cpu": flips(logs["cpu_float32"],
                                           logs["cpu_float64"])},
            "routing": routing_report(logs, "cpu_float64")}


def mtt_draw(seed):
    """The images and the mask generator of draw ``seed``: the draws of
    ``check_baselines_card_vs_cpu`` (the images, the S2D-DM check's slot
    bits, then the masks), so draw 0 is the DM checks' own."""
    c = BASELINES_SMALL
    nc, f, im = c["num_classes"], c["frames"], c["im_size"][0]
    gen = torch.Generator().manual_seed(seed)
    syn = torch.randn(nc, f, im, im, 3, generator=gen)
    torch.randint(0, 2, (2, nc), generator=gen)
    return syn, gen


def check_mtt_draw(m):
    """ROADMAP C.13's rule for one raw MTT draw: the loss within 1e-5 card
    against CPU; each fp32 device's outer gradients within FP64_NO_TIE of
    fp64, or within MTT_FP64_CAP if a max of that device's forward picked
    another winner than fp64's did."""
    assert m["card_vs_cpu"]["loss"] <= 1e-5, f"mtt card vs CPU: {m}"
    for dev in ("card", "cpu"):
        cap = MTT_FP64_CAP if m["flips_vs_fp64"][dev] else FP64_NO_TIE
        for k in ("grad_images", "grad_syn_lr"):
            d = m[f"{dev}_vs_fp64"][k]
            assert d <= cap, (
                f"mtt {dev}: {k} {d} from fp64 over {cap} "
                f"(flips {m['flips_vs_fp64']})")


def phase_baselines(tmp):
    """The baselines at full width through their drivers (DM, S2D-DM, raw
    MTT, k-center and herding), from one store, then the card against the
    CPU at a small size."""
    t0 = time.perf_counter()
    data_path = packed_synthetic(tmp, BASELINES["synthetic"],
                                 BASELINES["dataset"], "baselines_data")
    store = load_packed(os.path.join(
        data_path, f"{BASELINES['dataset']}_packed")).train
    emit({"phase": "baselines_store", "dataset": BASELINES["dataset"],
          "seconds": time.perf_counter() - t0,
          "train_clips": len(store), "gb": store.clips.nbytes / 1e9})
    baselines_dm(data_path, tmp, store)
    baselines_s2d_dm(data_path, tmp)
    baselines_s2d_dm_learns(data_path)
    baselines_mtt(data_path, tmp)
    baselines_coresets(data_path, store)
    check_baselines_card_vs_cpu()
    emit({"phase": "baselines", "seconds": time.perf_counter() - t0,
          "ok": True})
    return data_path


# FRePo at full width on the baselines' store, with the driver's defaults
# (ConvNet3D, ppc=dpc=1, n_hal=1, 10 pool nets of 100 online updates,
# batch_real 512, lr_d 1e2): 3 iterations, one evaluation at the last with
# one net of 10 epochs (the driver: 3 nets of 500)
FREPO = dict(iterations=3, num_eval=1, epoch_eval_train=10, seed=0)
# with the maxes' winners of fp64, an fp32 FRePo step stays this close to it:
# the KRR solve amplifies fp32 rounding (tests/test_torch_frepo.py: the two
# packages' fp32 gradients are 1.3-4.6e-5 apart)
FREPO_FP64_NO_TIE = 1e-4


def frepo_step_launches(real_chunks):
    """First-stage launches of one FRePo outer step: each real chunk's
    forward packs and takes the phase max; the prototypes' forward does too,
    and its backward into them scatters and unpacks; the pool step's forward
    does too, and its backward into the net scatters only."""
    return {"phase_argmax": real_chunks + 2, "phase_select": 0,
            "phase_scatter": 2, "s2d2_pack": real_chunks + 2,
            "s2d2_unpack": 1}


def phase_frepo(data_path, tmp):
    """FRePo through ``drivers.distill_frepo.main`` at full width; each step
    with the launch counts set to 0 just before it and checked just after;
    then the card against the CPU at a small size."""
    c = FREPO
    n = len(load_packed(os.path.join(
        data_path, f"{BASELINES['dataset']}_packed")).train)
    chunks = -(-min(frepo.FRePoConfig(num_classes=1).batch_real, n)
               // dm.REAL_CHUNK)
    want = frepo_step_launches(chunks)
    T, P = frepo.FRePoTrainer, frepo.ModelPool
    saved = (T.step, T.real_feats, T.proto_step, P.train_step,
             distill_frepo.krr_evaluate, distill_frepo.evaluate_many)
    steps, real, proto, pool_s, krr_s, nn_s, losses = ([] for _ in range(7))
    init, evals = {}, {}

    def step(self, *args, **kwargs):
        if not init:
            init.update(dynamic=self.state["dynamic"].clone(),
                        hal=self.state["hals"][0]["weight"].clone(),
                        static=self.static.clone(),
                        counts=[el["count"] for el in self.pool.elements])
        reset_first_stage()
        hc.reset_launches()
        hf.reset_launches()
        out = _timed(saved[0], steps)(self, *args, **kwargs)
        losses.append(out["loss"])
        if not np.isfinite(out["loss"]):
            raise AssertionError(f"FRePo: non-finite loss {out}")
        check_first_stage_counts("FRePo step", want)
        _check_hal_launches("FRePo step", {k: 1 for k in hc.LAUNCHES})
        assert hf.LAUNCHES["hal_fused"] == 1, dict(hf.LAUNCHES)
        return out

    def krr(*args, **kwargs):
        # compose_eval launched hal_fused once since the last step's check
        evals["hal_fused_compose_eval"] = hf.LAUNCHES["hal_fused"] - 1
        reset_first_stage()
        hc.reset_launches()
        hf.reset_launches()
        return _timed(saved[4], krr_s)(*args, **kwargs)

    def nn(*args, **kwargs):
        out = _timed(saved[5], nn_s)(*args, **kwargs)
        evals.update(first_stage=first_stage_launches(),
                     hal_conv=dict(hc.LAUNCHES), hal_fused=hf.LAUNCHES["hal_fused"])
        return out

    T.step, T.real_feats, T.proto_step = (step, _timed(saved[1], real),
                                          _timed(saved[2], proto))
    P.train_step = _timed(saved[3], pool_s)
    distill_frepo.krr_evaluate, distill_frepo.evaluate_many = krr, nn
    logger = RecordingLogger()
    torch.cuda.reset_peak_memory_stats()
    try:
        run_s, res = _synced_seconds(lambda: distill_frepo.main(
            ["--dataset", BASELINES["dataset"], "--data_path", data_path,
             "--save_path", os.path.join(tmp, "frepo"),
             "--Iteration", str(c["iterations"]),
             "--eval_it", str(c["iterations"]), "--num_eval", str(c["num_eval"]),
             "--epoch_eval_train", str(c["epoch_eval_train"]),
             "--seed", str(c["seed"]), "--device", "cuda"], logger=logger))
    finally:
        T.step, T.real_feats, T.proto_step = saved[:3]
        P.train_step = saved[3]
        distill_frepo.krr_evaluate, distill_frepo.evaluate_many = saved[4:]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr = res["trainer"]
    st = tr.state
    moved = {"dynamic": float((st["dynamic"] - init["dynamic"]).abs().max()),
             "hal": float((st["hals"][0]["weight"] - init["hal"]).abs().max())}
    scalars = {k: v for _, rec in logger.records for k, v in rec.items()}
    accs = {"krr": scalars["KRR_Accuracy"], "nn": scalars["Accuracy/ConvNet3D"]}
    timed = slice(1, None)
    row = {"phase": "frepo", "driver_seconds": run_s, "steps": len(steps),
           "losses": losses, "accuracy": accs, "max_abs_change": moved,
           "pool_counts": [el["count"] for el in tr.pool.elements],
           "ms_per_step": float(np.mean(steps[timed])) * 1e3,
           "ms_real_embed": float(np.mean(real[timed])) * 1e3,
           "ms_synthetic_side": float(np.mean(proto[timed])
                                      - np.mean(real[timed])) * 1e3,
           "ms_pool_step": float(np.mean(pool_s[timed])) * 1e3,
           "krr_eval_seconds": krr_s[0], "nn_eval_seconds": nn_s[0],
           "real_chunks": chunks,
           "launches_per_step": {**want, **{k: 1 for k in hc.LAUNCHES},
                                 "hal_fused": 1},
           "evaluation_launches": evals,
           "max_memory_allocated_gb": peak}
    emit(row)
    assert all(v > 0 for v in moved.values()), moved
    assert torch.equal(tr.static, init["static"])  # frozen
    assert all(_finite(t) for t in (st["dynamic"], st["hals"][0]["weight"]))
    # one pool net trains a step an iteration; none reaches 100 and resets
    assert sum(row["pool_counts"]) - sum(init["counts"]) == c["iterations"]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in accs.values()), accs
    # the evaluation: compose_eval once, then KRR (the prototypes and one
    # batch of test clips forward) and the nets trained on the composed
    # tensor (11 first-order steps, one test batch): no hal_* kernel
    assert evals["hal_fused_compose_eval"] == 1, evals
    assert evals["hal_fused"] == 0 and not any(evals["hal_conv"].values()), evals
    assert evals["first_stage"] == first_order(
        (c["epoch_eval_train"] + 1) * c["num_eval"], 2 + c["num_eval"]), evals
    emit({"phase": "frepo", "ok": True})
    check_frepo_card_vs_cpu()
    return row


def check_frepo_card_vs_cpu():
    """One FRePo proto step and one pool step at 3 classes, 64x64x8, from
    the same state, pool net, real batch, prototypes and dropout mask:
    fp32 on the card and on the CPU against fp64 on the CPU. Each fp32
    device's loss and gradients (the dynamic memory's, the hallucinator's,
    the pool net's) within FREPO_FP64_NO_TIE of fp64 (relative norm), or
    within MTT_FP64_CAP if a max of that device's forwards picked another
    winner than fp64's did (ROADMAP C.13)."""
    c = BASELINES_SMALL
    store = make_synthetic_video_data(**c).train
    nc, f, im = c["num_classes"], c["frames"], c["im_size"][0]
    cfg = frepo.FRePoConfig(num_classes=nc, frames=f, im_size=(im, im),
                            num_nn_state=2, max_online_updates=5, batch_real=8)
    static = np.random.default_rng(0).normal(size=(nc, im, im, 3)).astype(
        np.float32)
    base = frepo.FRePoTrainer(store, "ConvNet3D", cfg,
                              torch.Generator().manual_seed(1), static, "cpu")
    sd = base.state_dict()
    real_idx = torch.as_tensor(np.random.default_rng(2).choice(
        len(store), size=cfg.batch_real, replace=False))
    x = base.compose_eval()  # the pool step's input on every device
    y = base.state["y_syn"]
    mask = torch.rand(nc, 1, 1, 1, 128,
                      generator=torch.Generator().manual_seed(3)) < 0.5
    runs, logs = {}, {}
    for dev, dt in (("cpu", torch.float64), ("cpu", torch.float32),
                    ("cuda", torch.float32)):
        with routing_log(logs.setdefault(f"{dev}_{str(dt)[6:]}", [])):
            tr = frepo.FRePoTrainer(store, "ConvNet3D", cfg, None, static,
                                    dev, dt)
            tr.load_state_dict(sd)
            loss, _, _, g = tr.proto_step(tr.pool.params(0), real_idx.to(dev))
            tr.pool.train_step(0, x.to(dev, dt), y.to(dev, dt), None, None,
                               mask.to(dev))
        runs[dev, dt] = {"loss": loss.reshape(1), "grad_dynamic": g["dynamic"],
                         "grad_hal_weight": g["hals"][0]["weight"],
                         "grad_hal_bias": g["hals"][0]["bias"],
                         "grad_pool_net": tr.pool.elements[0]["m"]}
    ref = runs["cpu", torch.float64]
    dist = {name: {k: _rel(v, ref[k]) for k, v in runs[dev, torch.float32].items()}
            for name, dev in (("card", "cuda"), ("cpu", "cpu"))}
    flipped = {name: flips(logs[key], logs["cpu_float64"])
               for name, key in (("card", "cuda_float32"),
                                 ("cpu", "cpu_float32"))}
    caps = {name: MTT_FP64_CAP if n else FREPO_FP64_NO_TIE
            for name, n in flipped.items()}
    emit({"phase": "frepo_card_vs_cpu", "rel_norm_vs_fp64": dist,
          "card_vs_cpu": {k: _rel(v, runs["cpu", torch.float32][k])
                          for k, v in runs["cuda", torch.float32].items()},
          "flips_vs_fp64": flipped, "caps": caps,
          "routing": routing_report(logs, "cpu_float64")})
    for name, d in dist.items():
        for k, v in d.items():
            assert v <= caps[name], (
                f"FRePo {name}: {k} {v} from fp64 over {caps[name]}")
    emit({"phase": "frepo_card_vs_cpu", "ok": True})


def main():
    use_exact_fp32()
    phase_build()
    rows = phase_check()
    phase_check_vmap()
    phase_parity()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_slice(tmp)
        rows.update(phase_check_first_stage())
        rows["hal_fused"] = phase_check_fused()
        launches["hal_fused"], pipe = phase_pipeline(tmp)
        phase_convert(tmp, pipe)
        del pipe
        phase_expert()
        phase_static(tmp)
        data_path = phase_baselines(tmp)
        phase_frepo(data_path, tmp)
        phase_zoo(data_path, tmp)
        phase_images(tmp)
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
