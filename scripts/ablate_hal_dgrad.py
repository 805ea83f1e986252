"""Where ``hal_dgrad``'s, ``s2d2_unpack``'s, ``hal_fwd``'s and
``hal_fused``'s time goes, by ablation, on one NVIDIA GPU.

    python3 scripts/ablate_hal_dgrad.py [--kernel hal_dgrad|s2d2_unpack|hal_fwd|hal_fused]
                                        [--fused-source FILE]

Builds variants of ``video_distillation_torch/csrc/hal_conv.cu`` (bf16
``hal_dgrad``, dd only, as the S2D-MTT slice runs it, and ``hal_fwd``), of
``csrc/s2d2_move.cu`` (``s2d2_unpack``) and of ``csrc/hal_fused.cu``, each
with one part cut out or one setting changed by a text substitution (a cut
variant's results are wrong; only its time counts), into
``video_distillation_torch/_build/ablate/`` with nvcc, one process per
variant in parallel. Then times each through its C interface at the main
path's shapes: ``hal_dgrad`` on ȳ (B=500, 3, F, 112, 112) and bf16
``hal_fwd`` on static (500, 112, 112, 3) and dynamic (500, F, 112, 112, 1),
each with F = 16 and 1 (the F=1 time is the per-block fixed cost plus one
frame), ``s2d2_unpack`` on the packed (50, 16, 60, 60, 36) cotangent;
``hal_fused`` at the evaluation shape (B=50, F = 16 and 1, 112x112, fp32), its launches replayed
from a CUDA graph so that a short one is not timed at the host's launch
rate, beside ``hal_fwd`` in fp32 on the same inputs and a plain fill of y.
``--fused-source`` times the variants of another ``hal_fused.cu``: the
one-thread-a-pixel design of commit 8e5e6b8 has its own table. Prints one
JSON line per variant (``hal_fwd``'s and ``hal_fused``'s with ptxas's
registers and spill bytes), then the card's name and power limit. About a
minute a kernel on an H100, most of it the parallel builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from video_distillation_torch.ops import build  # noqa: E402

# variant -> [(text, replacement)]; every text must occur in the source
# after the kernel's marker, where the substitution is made
DGRAD_MARK = "hal_dgrad_kernel(const T* __restrict__ g"
DGRAD = {
    "full": [],
    "no_tap_products": [  # neither the operand loads nor the mma
        ("for (int kh = 0; kh < 3; ++kh) {\n          // tile row of image row",
         "for (int kh = 0; kh < 0; ++kh) {\n          // tile row of image row")],
    "no_mma": [  # the operand loads feed a cheap sum instead
        ("mma_bf16(acc[k][0], ae, bh[kh][0].x, bh[kh][0].y);",
         "acc[k][0][0] += __uint_as_float((ae[0] ^ ae[2]) & 0x3fffffffu);"),
        ("mma_bf16(acc[k][1], ao, bh[kh][1].x, bh[kh][1].y);",
         "acc[k][1][0] += __uint_as_float((ao[1] ^ ao[3]) & 0x3fffffffu);")],
    "no_operand_loads": [  # the mma on operands made in registers
        ("lds128(x0 + 1, words + base + q);",
         "for (int i = 0; i < 6; ++i) x0[i] = x1[i] = (base + q + i) * 0x00010001u;"),
        ("x0[0] = words[base + q - 1];", ""), ("x0[5] = words[base + q + 4];", ""),
        ("lds128(x1 + 1, words + base + lane_row + q);", ""),
        ("x1[0] = words[base + lane_row + q - 1];", ""),
        ("x1[5] = words[base + lane_row + q + 4];", "")],
    "twice_the_operand_loads": [  # each 16-byte load issued twice
        ("lds128(x0 + 1, words + base + q);",
         "lds128(x0 + 1, words + base + q);\n        lds128(x0 + 1, words + base + q);"),
        ("lds128(x1 + 1, words + base + lane_row + q);",
         "lds128(x1 + 1, words + base + lane_row + q);\n"
         "        lds128(x1 + 1, words + base + lane_row + q);")],
    "twice_the_mma": [  # each product issued twice
        ("mma_bf16(acc[k][0], ae, bh[kh][0].x, bh[kh][0].y);",
         "mma_bf16(acc[k][0], ae, bh[kh][0].x, bh[kh][0].y);\n"
         "          mma_bf16(acc[k][0], ae, bh[kh][0].x, bh[kh][0].y);"),
        ("mma_bf16(acc[k][1], ao, bh[kh][1].x, bh[kh][1].y);",
         "mma_bf16(acc[k][1], ao, bh[kh][1].x, bh[kh][1].y);\n"
         "          mma_bf16(acc[k][1], ao, bh[kh][1].x, bh[kh][1].y);")],
    "operands_loaded_into_quads": [  # each mma's A words loaded for it alone
        ("const uint32_t ae[4] = {x0[k + 1], x1[k + 1], x0[k], x1[k]};\n"
         "            const uint32_t ao[4] = {x0[k + 1], x1[k + 1], x0[k + 2], x1[k + 2]};",
         "uint32_t ae[4], ao[4];\n"
         "            const int o[4] = {base + q + k, base + lane_row + q + k, "
         "base + q + k - 1, base + lane_row + q + k - 1};\n"
         "            for (int i = 0; i < 4; ++i) {\n"
         "              asm volatile(\"ld.shared.u32 %0, [%1];\" : \"=r\"(ae[i]) "
         ": \"r\"(smem_addr(words + o[i])));\n"
         "              asm volatile(\"ld.shared.u32 %0, [%1];\" : \"=r\"(ao[i]) "
         ": \"r\"(smem_addr(words + o[i] + (i < 2 ? 0 : 2))));\n"
         "            }")],
    "no_streaming": [  # only the first kDRing frames are loaded
        ("mbar_arrive_expect_tx(&full[s], 3 * nrows * ncols * (int)sizeof(T));",
         "mbar_arrive_expect_tx(&full[s], t < kDRing ? 3 * nrows * ncols * (int)sizeof(T) : 0);"),
        ("for (int k = lane; k < 3 * nrows; k += 32) {\n          const int co",
         "for (int k = lane; k < (t < kDRing ? 3 * nrows : 0); k += 32) {\n          const int co")],
    "no_dd_stores": [("      if (tt >= 0) {\n        store8", "      if (tt >= 1 << 30) {\n        store8")],
}
DGRAD_SETTINGS = {  # settings changed before the kernel's marker
    "two_frames_ahead": [("constexpr int kDAhead = 3;", "constexpr int kDAhead = 2;")],
    "four_frames_ahead": [("constexpr int kDAhead = 3;", "constexpr int kDAhead = 4;")],
    "one_block_an_sm": [("__launch_bounds__(kDThreads, kS ? 1 : 2)",
                          "__launch_bounds__(kDThreads, 1)")],
    "three_blocks_an_sm": [("__launch_bounds__(kDThreads, kS ? 1 : 2)",
                            "__launch_bounds__(kDThreads, kS ? 1 : 3)")],
}
# hal_fwd: each text must occur once in the whole source
FWD = {
    "full": [],
    "no_stores": [  # the sums stay live, but almost never leave
        ("    if (!owner) return;\n    T* p = yp",
         "    if (!owner || a[0][0] != -12345.f) return;\n    T* p = yp")],
    "no_dynamic_loads": [  # the window made in registers, no shared loads
        ("      load_win(win + kh * RS, v);",
         "      for (int j = 0; j < V + 2; ++j) v[j] = __uint_as_float(0x3f800000u + e0 + kh + j);")],
    "no_staging": [  # only frames 0-2 are copied into the ring
        ("      if (t + 2 < F) stage(t + 2, (P + 2) % 3);\n", "")],
    "no_dynamic_ffma": [  # a sum a pixel and tap column instead of 27 FFMAs
        ("            nx[co][i] += fw(widx(0, kh, kw, 3, co)) * v[i + kw];\n"
         "            cu[co][i] += fw(widx(1, kh, kw, 3, co)) * v[i + kw];\n"
         "            pv[co][i] += fw(widx(2, kh, kw, 3, co)) * v[i + kw];",
         "            if (co == 0) cu[0][i] += v[i + kw];")],
    "no_static": [  # neither the static's staging nor its stencils
        ("const int n3 = ncols * 3,", "const int n3 = 0,"),
        ("for (int ci = 0; ci < 3; ++ci) {\n#pragma unroll\n      for (int kh",
         "for (int ci = 0; ci < 0; ++ci) {\n#pragma unroll\n      for (int kh")],
    "weights_in_shared_memory": [  # the parent's weight path: a shared load an FFMA operand
        ("__device__ __forceinline__ float fw(int i) { return c_fwd_w[i]; }",
         "__shared__ float sw_fwd[kNWB];\n"
         "__device__ __forceinline__ float fw(int i) { return sw_fwd[i]; }"),
        ("  // zeros: what lies outside the image stays so\n",
         "  for (int q = tid; q < kNWB; q += nt) sw_fwd[q] = c_fwd_w[q];\n")],
    "base_in_registers": [  # base kept in registers, not read from the record
        ("    read_rec(0, nx);",
         "    for (int co = 0; co < 3; ++co)\n"
         "      for (int i = 0; i < V; ++i) nx[co][i] = base[co][i];")],
    "four_pixels_a_thread": [  # bf16: runs of 4 pixels, 3 blocks an SM
        ("static constexpr int V = sizeof(T) == 2 ? 8 : 4;", "static constexpr int V = 4;"),
        ("__launch_bounds__(kFThreads, 2)\nhal_fwd_kernel",
         "__launch_bounds__(kFThreads, 3)\nhal_fwd_kernel")],
    "one_block_an_sm": [("__launch_bounds__(kFThreads, 2)\nhal_fwd_kernel",
                         "__launch_bounds__(kFThreads, 1)\nhal_fwd_kernel")],
    "three_blocks_an_sm": [("__launch_bounds__(kFThreads, 2)\nhal_fwd_kernel",
                            "__launch_bounds__(kFThreads, 3)\nhal_fwd_kernel")],
}
# hal_fused: each text must occur once in the whole source. FUSED_PIXEL
# cuts the one-thread-a-pixel design (csrc/hal_fused.cu as of commit
# 8e5e6b8, for --fused-source); the table is the one whose first text the
# source holds.
FUSED_PIXEL = {
    "full": [],
    "no_stores": [  # the sums stay live, but almost never leave
        ("      yb[co * plane + (size_t)t * HW + p] = acc;",
         "      if (acc == -12345.f) yb[co * plane + (size_t)t * HW + p] = acc;")],
    "no_dynamic_loads": [  # the window made in registers
        ("? plane[hh * W + ww] : 0.f;",
         "? __uint_as_float(0x3f800000u + hh * W + ww) : 0.f;")],
    "no_dynamic_ffma": [  # a sum of 9 window values instead of 81 FFMAs
        ("acc += sw[widx(kt, k / 3, k % 3, 3, co)] * win[kt][k];",
         "if (co == 0 && kt == 1) acc += win[kt][k];")],
    "no_static": [  # neither the static's loads nor its stencils
        ("if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;\n      const float* sp",
         "if (true) continue;\n      const float* sp")],
    "weights_in_constant_bank": [  # each FFMA's weight from the constant bank
        ("  __shared__ float sw[kNWB];\n"
         "  for (int i = threadIdx.x; i < kNWB; i += blockDim.x) sw[i] = wb[i];\n"
         "  __syncthreads();\n", ""),
        ("__global__ void __launch_bounds__(kThreads)\nhal_fused_kernel",
         "__constant__ float sw[kNWB];\n\n"
         "__global__ void __launch_bounds__(kThreads)\nhal_fused_kernel"),
        ("  const int HW = H * W;\n  const dim3 grid",
         "  cudaMemcpyToSymbolAsync(sw, wb, kNWB * sizeof(float), 0,\n"
         "                          cudaMemcpyDeviceToDevice, (cudaStream_t)stream);\n"
         "  const int HW = H * W;\n  const dim3 grid")],
}
FUSED = {
    "full": [],
    "no_stores": [  # the sums stay live, but almost never leave
        ("    if (!owner) return;\n",
         "    if (!owner || a[0][0] != -12345.f) return;\n")],
    "no_dynamic_loads": [  # the window made in registers, no shared loads
        ("      load_win(win + kh * RS, v);",
         "      for (int j = 0; j < 6; ++j) v[j] = __uint_as_float(0x3f800000u + e0 + kh + j);")],
    "no_staging": [  # only frames 0 .. kAhead-1 are copied into the ring
        ("    if (t + kAhead < F) stage(t + kAhead, (t + kAhead) % kSlots);\n", "")],
    "no_dynamic_ffma": [  # a sum a pixel and tap column instead of 27 FFMAs
        ("            nx[co][i] += wt(widx(0, kh, kw, 3, co)) * v[i + kw];\n"
         "            cu[co][i] += wt(widx(1, kh, kw, 3, co)) * v[i + kw];\n"
         "            pv[co][i] += wt(widx(2, kh, kw, 3, co)) * v[i + kw];",
         "            if (co == 0) cu[0][i] += v[i + kw];")],
    "no_static": [  # neither the static's copies nor its stencils
        ("const int n3 = T.ncols * 3,", "const int n3 = 0,"),
        ("for (int kh = 0; kh < 3; ++kh) {\n      float w[kWRow], v[20];",
         "for (int kh = 0; kh < 0; ++kh) {\n      float w[kWRow], v[20];"),
        ("    if (t == 1) sub_stencil(Phase<0>(), pv);\n", ""),
        ("    if (F == 1) sub_stencil(Phase<0>(), pv);\n    sub_stencil(Phase<2>(), pv);\n", "")],
    "no_u0_u2": [  # outputs 0 and F-1 keep their u0 and u2
        ("    if (t == 1) sub_stencil(Phase<0>(), pv);\n", ""),
        ("    if (F == 1) sub_stencil(Phase<0>(), pv);\n    sub_stencil(Phase<2>(), pv);\n", "")],
    "weights_in_shared_memory": [  # a shared load an FFMA operand
        ("__device__ __forceinline__ float wt(int i) { return c_w[i]; }",
         "__shared__ float sw[kNWB];\n"
         "__device__ __forceinline__ float wt(int i) { return sw[i]; }"),
        ("  // zeros: what lies outside the image stays so\n",
         "  for (int q = tid; q < kNWB; q += nt) sw[q] = c_w[q];\n  __syncthreads();\n")],
    "no_weight_copy": [  # the constant bank is not refilled before the launch
        ("  int rc = (int)cudaMemcpyToSymbolAsync(c_w, wb, kNWB * sizeof(float), 0,\n"
         "                                        cudaMemcpyDeviceToDevice, stream);",
         "  int rc = 0;")],
    "three_frames_ahead": [("constexpr int kAhead = 2;", "constexpr int kAhead = 3;")],
    "two_blocks_an_sm": [("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 2;")],
}
# every FFMA cut: the copies and stores alone; then the stores alone
FUSED["memory_only"] = FUSED["no_dynamic_ffma"] + FUSED["no_static"][1:]
FUSED["stores_only"] = (FUSED["no_dynamic_ffma"] + FUSED["no_static"] + FUSED["no_staging"]
                        + FUSED["no_dynamic_loads"])
FUSED_TABLES = [FUSED, FUSED_PIXEL]
UNPACK_MARK = "s2d2_unpack_kernel(const T* __restrict__ g"
UNPACK = {
    "full": [],
    "no_staging": [("cp_async16(dst + r * RL + c, src + (size_t)r * Wc * K + c);", "")],
    "no_slot_loads": [
        ("if (fmask >> dt & 1) acc += to_f<T>(sl[dt][off]);",
         "if (fmask >> dt & 1) acc += (float)(off + dt);")],
    "no_stores": [("*reinterpret_cast<uint4*>(o + e) = pk.v;",
                   "if (pk.v.x == 0x7fc17fc1u) *reinterpret_cast<uint4*>(o + e) = pk.v;")],
}
UNPACK_SETTINGS = {
    "two_frames_ahead": [("constexpr int kUAhead = 1;", "constexpr int kUAhead = 2;")],
    "four_frames_a_block": [("constexpr int kUFrames = 8;", "constexpr int kUFrames = 4;")],
    "sixteen_frames_a_block": [("constexpr int kUFrames = 8;", "constexpr int kUFrames = 16;")],
    "slot_16k": [("constexpr int kUnpackSlotBytes = 8 * 1024;",
                  "constexpr int kUnpackSlotBytes = 16 * 1024;")],
    "threads_128": [("constexpr int kUThreads = 256;", "constexpr int kUThreads = 128;")],
}


def variant_sources(src, mark, cuts, settings):
    i = src.index(mark)
    head, tail = src[:i], src[i:]
    texts = {}
    for name, subs in {**cuts, **settings}.items():
        h, t = head, tail
        for old, new in subs:
            part = t if name in cuts else h
            if old not in part:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            if name in cuts:
                t = t.replace(old, new)
            else:
                h = h.replace(old, new)
        texts[name] = h + t
    return texts


def whole_source_variants(src, variants):
    texts = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build_variants(texts, tag, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    try:
        for name, text in texts.items():
            cu = os.path.join(out_dir, f"{tag}_{name}.cu")
            with open(cu, "w") as fh:
                fh.write(text)
            so = os.path.join(out_dir, f"lib{tag}_{name}.so")
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
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(so)
    return libs, logs


def ptxas(log, entry):
    """ptxas's registers and spill bytes (stores + loads) for the kernel
    whose mangled name contains ``entry``, from an nvcc -Xptxas -v log."""
    out, cur = {}, False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = entry in m.group(1)
        elif cur and (m := re.search(r"Used (\d+) registers", ln)):
            out["registers"] = int(m.group(1))
        elif cur and "spill" in ln:
            out["spill_bytes"] = sum(map(int, re.findall(r"(\d+) bytes spill", ln)))
    return out


def cuda_ms(fn, iters=20):
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


def graph_ms(fn, iters=50):
    """Mean device time of ``fn`` over ``iters`` launches replayed from one
    CUDA graph, so a short kernel is not timed at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def checked(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")


def ablate_dgrad(out_dir):
    src = (build.CSRC_DIR / "hal_conv.cu").read_text()
    libs, _ = build_variants(variant_sources(src, DGRAD_MARK, DGRAD, DGRAD_SETTINGS),
                             "dgrad", out_dir)
    b, f, h, w = 500, 16, 112, 112
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(b, 3, f, h, w, generator=gen, device="cuda").bfloat16()
    wb = torch.randn(327, generator=gen, device="cuda").bfloat16().float()
    dd = torch.empty(b, f, h, w, device="cuda", dtype=torch.bfloat16)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.hal_dgrad.argtypes = [i, p, p, p, p, i, i, i, i, p]

        def call(frames, lib=lib):
            # frames < f reads the first frames of each sample's planes
            checked(lib.hal_dgrad(1, g.data_ptr(), wb.data_ptr(), None,
                                  dd.data_ptr(), b, frames, h, w, stream()),
                    name)
        print(json.dumps({"kernel": "hal_dgrad", "variant": name,
                          **{f"ms_F{n}": cuda_ms(lambda: call(n)) for n in (f, 1)}}),
              flush=True)


def ablate_unpack(out_dir):
    src = (build.CSRC_DIR / "s2d2_move.cu").read_text()
    libs, _ = build_variants(variant_sources(src, UNPACK_MARK, UNPACK, UNPACK_SETTINGS),
                             "unpack", out_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(50, 16, 60, 60, 36, generator=gen, device="cuda").bfloat16()
    out = torch.empty(50, 16, 112, 112, 3, device="cuda", dtype=torch.bfloat16)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.s2d2_unpack.argtypes = [i, p, p, i, i, i, i, i, p]
        ms = cuda_ms(lambda lib=lib: checked(lib.s2d2_unpack(
            1, g.data_ptr(), out.data_ptr(), 50, 16, 112, 112, 3, stream()), name))
        print(json.dumps({"kernel": "s2d2_unpack", "variant": name, "ms": ms}),
              flush=True)


def ablate_fwd(out_dir):
    src = (build.CSRC_DIR / "hal_conv.cu").read_text()
    libs, logs = build_variants(whole_source_variants(src, FWD), "fwd", out_dir)
    b, f, h, w = 500, 16, 112, 112
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = torch.randn(b, h, w, 3, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(b, f, h, w, 1, generator=gen, device="cuda").bfloat16()
    wb = torch.randn(327, generator=gen, device="cuda")
    y = torch.empty(b, 3, f, h, w, device="cuda", dtype=torch.bfloat16)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.hal_fwd.argtypes = [i, p, p, p, p, i, i, i, i, p]

        def call(frames, lib=lib):
            # frames < f reads the first frames of each sample's dynamic
            checked(lib.hal_fwd(1, st.data_ptr(), dy.data_ptr(), wb.data_ptr(),
                                y.data_ptr(), b, frames, h, w, stream()), name)
        print(json.dumps({"kernel": "hal_fwd", "variant": name,
                          **{f"ms_F{n}": cuda_ms(lambda: call(n)) for n in (f, 1)},
                          # the bf16 instantiation for 16-byte rows
                          **ptxas(logs[name], "hal_fwd_kernelI13__nv_bfloat16Lb1E")}),
              flush=True)


EVAL_SHAPE = (50, 16, 112, 112)


def fused_inputs():
    """static, dynamic, the 327 flat weights and y at the evaluation shape,
    fp32."""
    b, f, h, w = EVAL_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = torch.randn(b, h, w, 3, generator=gen, device="cuda")
    dy = torch.randn(b, f, h, w, 1, generator=gen, device="cuda")
    wb = 0.2 * torch.randn(327, generator=gen, device="cuda")
    y = torch.empty(b, 3, f, h, w, device="cuda")
    return st, dy, wb, y


def ablate_fused(out_dir, source):
    """hal_fused's variants at the evaluation shape through its C interface,
    with F = 16 and 1, beside hal_fwd in fp32 on the same inputs."""
    src = open(source).read()
    table = next(t for t in FUSED_TABLES if t["no_stores"][0][0] in src)
    libs, logs = build_variants(whole_source_variants(src, table), "fused", out_dir)
    st, dy, wb, y = fused_inputs()
    b, f, h, w = EVAL_SHAPE
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.hal_fused.argtypes = [p, p, p, p, i, i, i, i, p]

        def call(frames, lib=lib):
            # frames < f reads the first frames of each sample's dynamic
            checked(lib.hal_fused(st.data_ptr(), dy.data_ptr(), wb.data_ptr(),
                                  y.data_ptr(), b, frames, h, w, stream()), name)
        print(json.dumps({"kernel": "hal_fused", "variant": name,
                          **{f"ms_F{n}": graph_ms(lambda: call(n)) for n in (f, 1)},
                          **ptxas(logs[name], "hal_fused_kernel")}),
              flush=True)
    print(json.dumps({"kernel": "fill_", "variant": "y alone (torch)",
                      "ms_F16": graph_ms(lambda: y.fill_(1.0))}), flush=True)
    lib = build.load("hal_conv")
    lib.hal_fwd.argtypes = [i, p, p, p, p, i, i, i, i, p]

    def fwd(frames):
        checked(lib.hal_fwd(0, st.data_ptr(), dy.data_ptr(), wb.data_ptr(),
                            y.data_ptr(), b, frames, h, w, stream()), "hal_fwd")
    print(json.dumps({"kernel": "hal_fwd_fp32", "variant": "same inputs",
                      **{f"ms_F{n}": graph_ms(lambda: fwd(n)) for n in (f, 1)}}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append",
                    choices=["hal_dgrad", "s2d2_unpack", "hal_fwd", "hal_fused"],
                    help="default: all four")
    ap.add_argument("--fused-source", default=str(build.CSRC_DIR / "hal_fused.cu"),
                    help="the hal_fused source whose variants are timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ablate_hal_dgrad.py: needs a CUDA device")
    out_dir = str(build.BUILD_DIR / "ablate")
    kernels = args.kernel or ["hal_dgrad", "s2d2_unpack", "hal_fwd", "hal_fused"]
    if "hal_dgrad" in kernels:
        ablate_dgrad(out_dir)
    if "s2d2_unpack" in kernels:
        ablate_unpack(out_dir)
    if "hal_fwd" in kernels:
        ablate_fwd(out_dir)
    if "hal_fused" in kernels:
        ablate_fused(out_dir, args.fused_source)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
