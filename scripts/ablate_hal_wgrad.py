"""Where ``hal_wgrad``'s time goes, by ablation, on one NVIDIA GPU.

    python3 scripts/ablate_hal_wgrad.py

Builds variants of ``video_distillation_torch/csrc/hal_conv.cu``, each with
one part of the bf16 wgrad kernel cut out by a text substitution (their
results are wrong; only their times count), into
``video_distillation_torch/_build/ablate/`` with nvcc, one process per
variant in parallel. Then times each through its C interface at the
S2D-MTT slice's shape (B=500, 112x112, bf16) with F = 16, 1 and 4 frames:
the F=1 time is the per-block fixed cost (prologue, static products,
reduction, finish kernel) plus one frame. Prints one JSON line per variant,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_distillation_torch.ops import build  # noqa: E402

SHAPE = dict(b=500, f=16, h=112, w=112)
MAIN_LOOP = "for (int r = warp; r < nr; r += kWarps) {"
# variant -> [(text, replacement)]; every text must occur in the source.
# The last two change a setting instead of cutting a part.
VARIANTS = {
    "full": [],
    "no_tensor_core_loop": [
        (MAIN_LOOP, "for (int r = warp; r < 0 * nr; r += kWarps) {")],
    "no_streaming": [
        ("if (t + kAhead < F) stage_g(t + kAhead);", ""),
        ("if (t + kAhead + 1 < F) {\n      stage_d(t + kAhead + 1);",
         "if (false) {")],
    "no_frame_sum": [
        ("const int nsum = 3 * GPe / V;", "const int nsum = 0 * GPe / V;")],
    "no_static_products": [
        ("for (int kb = warp; kb < nr * nwb; kb += kWarps) {",
         "for (int kb = warp; kb < 0 * nr * nwb; kb += kWarps) {")],
    "no_static_split": [
        ("for (int ci = 0; ci < 3; ++ci) planes[ci * SWe + e] = sraw[p * 3 + ci];",
         "{}"),
        ("reinterpret_cast<uint32_t*>(sraw)[q] = 0u;", "{}")],
    "no_zero_fill": [
        ("reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);", "{}")],
    "no_finish_kernel": [
        ("  hal_wgrad_finish_kernel<<<kNWB, kThreads, 0, stream>>>"
         "(part, nchunk * B, out);\n", "")],
    "no_ninth_group_loads": [
        ("const uint32_t u0 = s[e + eo], u1 = s[e + eo + 1], u2 = s[e + eo + 2];",
         "const uint32_t u0 = wm, u1 = wp, u2 = wm ^ wp;")],
    "one_bank_group": [  # every lane of a load at the same words: no conflicts
        ("const int rq = r * L.RWd + kPad / 2 + 2 * tig;",
         "const int rq = r * L.RWd + kPad / 2;"),
        ("const int d_g = ((t + kt + kRing - 1) % kRing) * L.SW + (gid - kt * 3) * L.RWd;",
         "const int d_g = ((t + kRing - 1) % kRing) * L.SW;")],
    "three_frames_ahead": [("constexpr int kAhead = 2;", "constexpr int kAhead = 3;")],
    "four_blocks_an_sm": [
        ("__global__ void __launch_bounds__(kThreads, 3)",
         "__global__ void __launch_bounds__(kThreads, 4)")],
}


def build_variants(out_dir):
    src = (build.CSRC_DIR / "hal_conv.cu").read_text()
    texts = {}
    for name, subs in VARIANTS.items():  # all substitutions before any build
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in hal_conv.cu")
            text = text.replace(old, new)
        texts[name] = text
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    try:
        for name, text in texts.items():
            cu = os.path.join(out_dir, f"{name}.cu")
            with open(cu, "w") as fh:
                fh.write(text)
            so = os.path.join(out_dir, f"lib{name}.so")
            procs[name] = (subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
        logs = {name: proc.communicate()[0] for name, (proc, _) in procs.items()}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    libs = {}
    for name, (proc, so) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hal_wgrad.argtypes = [i, p, p, p, p, i, p, i, i, i, i, p]
        lib.hal_wgrad.restype = i
        libs[name] = lib
    return libs


def cuda_ms(fn, iters=10):
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


def main():
    if not torch.cuda.is_available():
        sys.exit("ablate_hal_wgrad.py: needs a CUDA device")
    libs = build_variants(str(build.BUILD_DIR / "ablate"))
    b, f, h, w = SHAPE["b"], SHAPE["f"], SHAPE["h"], SHAPE["w"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()  # noqa: E731
    st, dy, g = mk(b, h, w, 3), mk(b, f, h, w, 1), mk(b, 3, f, h, w)
    nchunk = -(-h // 8)
    part = torch.empty(nchunk * b, 327, device="cuda")
    out = torch.empty(327, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(lib, frames):
        # frames < f reads the first frames of each sample's planes
        rc = lib.hal_wgrad(1, g.data_ptr(), st.data_ptr(), dy.data_ptr(),
                           part.data_ptr(), nchunk, out.data_ptr(), b, frames,
                           h, w, stream)
        if rc != 0:
            raise RuntimeError(f"hal_wgrad launch failed: cudaError_t {rc}")

    for name, lib in libs.items():
        print(json.dumps({"variant": name, **{
            f"ms_F{n}": cuda_ms(lambda: call(lib, n)) for n in (f, 1, 4)}}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
