// Hallucinator composition conv for Hopper (sm_90a): forward, dgrad, wgrad.
//
// The hallucinator is Conv3d(4 -> 3, k=3, pad=1) over [broadcast(static) |
// dynamic] plus a bias: static (B,H,W,3), dynamic (B,F,H,W,1),
// y (B,3,F,H,W) channel-planar. Weights arrive as one fp32 vector of 327
// values: the kernel flattened in (kt, kh, kw, ci, co) order (the JAX
// package's DHWIO layout, ci 0-2 static, ci 3 dynamic), then the 3 biases.
//
// Replaces the Pallas kernels of video_distillation_tpu/ops/pallas/hal_vjp.py:
//   hal_fwd_kernel    <- _fwd_kernel    (hal_vjp.py:79)
//   hal_dgrad_kernel  <- _dgrad_kernel  (hal_vjp.py:130)
//   hal_wgrad_*       <- _wgrad_kernel  (hal_vjp.py:185)
//
// What bounds them on an H100: all three move about 0.8 GB at the S2D-MTT
// shapes (B=500, F=16, 112x112, bf16), ~0.25 ms at 3.35 TB/s. Their 16-20
// GFLOP take 0.25-0.29 ms on the CUDA cores' fp32 FMA (67 TFLOP/s) but
// 0.02 ms on the tensor cores (989 TFLOP/s dense bf16), so in bf16 the
// bytes bound them.
//
// hal_fwd (its section is the last; H100 80GB HBM3, 700 W):
//  * What binds it: instruction issue. The dynamic taps are 81 FFMAs a
//    pixel and frame (8.1 G at the slice's bf16 shape), 0.24 ms at the data
//    sheet's 67 TFLOP/s; the static's three stencils add 1.5 G.
//    The first design (a thread a pixel, nine 2-byte loads a frame behind
//    bounds checks, a shared-memory load for each FFMA's weight) spent its
//    issue slots on everything but FFMAs: 1.31-1.34 ms, 19% of the byte
//    bound.
//  * Weights: copied to __constant__ memory on the launch's stream before
//    each launch; each FFMA takes its weight from the constant bank, with
//    no load (from shared memory as before: +0.05 ms).
//  * A thread owns a run of 8 neighbouring pixels of a row in bf16 (4 in
//    fp32). A window row (10 values) is one 16-byte and two 4-byte shared
//    loads and feeds 216 FFMAs; an output frame leaves as one 16-byte
//    store per channel plane.
//  * A block owns 256 consecutive runs counted row-major over all samples'
//    rows: 8 full warps, so the SM's four schedulers get equal shares at a
//    width of 112 (14 runs a row), where blocks of whole rows held 7 warps
//    and ran 0.542-0.546 ms against this one's 0.499-0.513.
//  * The dynamic frames stream through a ring of three shared tiles, two
//    frames ahead, with 16-byte cp.async copies from a list built once a
//    block, behind one barrier a frame. Zero rows and columns (halos, and
//    between two samples' rows) replace bounds checks in the tap loop.
//  * The static's three 2-D stencils (kt = 0, 1, 2 weights) are taken once
//    per pixel from its rows staged as they lie in memory; base and the
//    kt=2 stencil wait in a per-thread record in shared memory (kept in
//    registers they spill). On the tensor cores instead (bf16 hi + lo
//    weights, columns shuffled to each run's lane) they ran 0.68 ms. The
//    3-frame running sums stay in registers, the frame loop unrolled by
//    three.
//  * Where the rest goes (scripts/ablate_hal_dgrad.py --kernel hal_fwd):
//    0.506 ms in all, 0.339 without the dynamic FFMAs, 0.411 without the
//    static term, 0.476 without the stores or the frame copies.
// hal_wgrad and hal_dgrad (their sections below): a block per band of rows
// of a sample streams the frames through shared memory with cp.async, so
// each input is read once; in bf16 the taps run on the tensor cores
// (mma.sync). For wgrad the TPU accumulates over a sequential grid; here
// each block writes one row of partial sums and a second kernel sums the
// rows in a fixed order (deterministic, no atomics).
// Inputs may be fp32 or bf16; every sum is taken in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNW = 324;   // kernel taps: 3*3*3*4*3
constexpr int kNWB = 327;  // + 3 biases
constexpr int kThreads = 256;

__device__ __forceinline__ int widx(int kt, int kh, int kw, int ci, int co) {
  return (((kt * 3 + kh) * 3 + kw) * 4 + ci) * 3 + co;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// wgrad, pass 1: one block per (band of kBR pixel rows, sample) writes one
// row of 327 partial sums in the output's order: dk in (kt,kh,kw,ci,co)
// order, then db.
//
// The block streams the F frames through shared memory with cp.async, two
// frames ahead, behind one barrier a frame: ȳ frame t+2 and dynamic frame
// t+3 load while frame t is used. The dynamic frames sit in a ring of
// tiles (t-1 .. t+3) with a one-pixel halo, rows padded to 16 bytes, and
// cp.async writes them in place; rows outside the image and frames -1 and
// F stay zero. The static's three channels are split into tiles of the same
// layout once per block.
//
// bf16: the dynamic taps are a GEMM, [27 taps, padded to 32] x [16-pixel
// k-blocks] x [3 co, padded to 8], on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 sums; bf16 products are exact in fp32).
// wgmma wants 64-row tiles of a product whose M is 27 and whose operands
// are shifted views of a 3-frame window, so the warp-level mma.sync is
// taken: each warp owns whole k-blocks, and no warpgroup sync or
// descriptor is needed. A lane's four A rows are one (kt, kh) group at
// kw = 0, 1, 2 plus a ninth group's tap: it loads the three aligned words
// around its pixel pair and forms the kw = 0 and 2 pairs with one byte
// permute each, so no operand needs an unaligned load or a copy of the tile.
// The static taps take the same path on the static tiles: frame 0 and frame
// F-1 (Bf, Bl) as they pass, and Σ_t ȳ (A) at the end, split into bf16
// hi + lo (exact to about 2^-16 relative). kt=1 takes A, kt=0 A - Bf and
// kt=2 A - Bl.
// fp32: the same tiles on FFMA (TF32 would change the result): a thread
// per pixel for the dynamic taps, a thread per column for the static ones.
// ---------------------------------------------------------------------------
constexpr int kBR = 8;  // pixel rows a wgrad block; ops/hal_conv.py agrees
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 2;  // ȳ frames in flight ahead of the one in use (3 is slower)
constexpr int kGbuf = kAhead + 1;
constexpr int kRing = 8;  // dynamic frames t-1 .. t+kAhead+1; 8 keeps the banks apart
// Σ_t ȳ: a thread keeps the 16-byte chunks q = tid + i*kThreads, i < 2, in
// registers; chunks past those (rows wider than 160 pixels) in shared memory
constexpr int kSumRegChunks = 2;
// the reduction's scratch: [dyn, A, Bf, Bl][warp][A row 32][co 4], then
// [warp][co] for the bias; its dynamic quarter fits in the ring's tiles
constexpr int kRedFloats = kWarps * 4 * 32 * 4;
constexpr int kRedBytes = (kRedFloats + kWarps * 3) * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B on the tensor cores: A 16x16 (taps x pixels) and B 16x8
// (pixels x co) in bf16, D 16x8 in fp32, in the m16n8k16 fragment layout.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the 16-byte chunk's values (8 bf16 or 4 fp32) in fp32
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
  x[0] = bf_lo(v.x); x[1] = bf_hi(v.x); x[2] = bf_lo(v.y); x[3] = bf_hi(v.y);
  x[4] = bf_lo(v.z); x[5] = bf_hi(v.z); x[6] = bf_lo(v.w); x[7] = bf_hi(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint32_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// shared-memory layout of a wgrad block, the same on the host (launch
// size) and the device. A tile holds kBR+2 rows (image rows h0-1 ..
// h0+kBR) of kPad zeros, the row, and zeros, as 32-bit words.
template <typename T>
struct WgradSmem {
  static constexpr int kEpw = 4 / sizeof(T);   // elements a word
  static constexpr int kPad = 16 / sizeof(T);  // elements before a row
  int Wk, RWd, SW, GPw;  // pixels a row padded to 16; words a tile row, a tile, a ȳ plane
  size_t planes, gbuf, g0, sall, total;  // byte offsets; the ring at 0
  __host__ __device__ explicit WgradSmem(int W) {
    Wk = (W + 15) / 16 * 16;
    // a half-warp's 64-bit loads of 4 (kt, kh) groups, or of the 3 co
    // planes of ȳ, fall in 4 different 8-bank windows: tile rows 8 mod 32
    // words apart, tiles 24 mod 32 (8 of them: 0 mod 32), planes 8
    RWd = (2 * kPad + Wk) / kEpw;
    RWd += (40 - RWd % 32) % 32;
    SW = (kBR + 2) * RWd;
    SW += (56 - SW % 32) % 32;
    GPw = kBR * Wk / kEpw;
    GPw += (40 - GPw % 32) % 32;
    planes = (size_t)kRing * SW * 4;
    const size_t tiles = planes + (size_t)3 * SW * 4;
    gbuf = tiles > (size_t)kRedBytes ? tiles : (size_t)kRedBytes;  // ȳ: 3 frames x 3 co
    g0 = gbuf + (size_t)kGbuf * 3 * GPw * 4;                      // ȳ frame 0
    sall = g0 + (size_t)3 * GPw * 4;                              // Σ_t ȳ, fp32
    total = sall + (size_t)3 * GPw * kEpw * 4;
  }
};

// copy nrows rows of ncols elements, 16 bytes a cp.async where ``vec``
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride,
                                           const T* __restrict__ src,
                                           int src_stride, int nrows,
                                           int ncols, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per = ncols / V;
    for (int q = threadIdx.x; q < nrows * per; q += blockDim.x) {
      const int r = q / per, c = (q - r * per) * V;
      cp_async16(dst + r * dst_stride + c, src + (size_t)r * src_stride + c);
    }
  } else {
    for (int q = threadIdx.x; q < nrows * ncols; q += blockDim.x) {
      const int r = q / ncols, c = q - r * ncols;
      dst[r * dst_stride + c] = src[(size_t)r * src_stride + c];
    }
  }
}

__device__ __forceinline__ uint32_t pair_up(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x5432);  // x's high half, then y's low half
}

// A fragments (two m-tiles) of a 16-pixel k-block. The k index is mapped
// so that lane tig holds pixels 4tig .. 4tig+3 of the block (k = 2tig,
// 2tig+1 -> 4tig, 4tig+1; k = 2tig+8, 2tig+9 -> 4tig+2, 4tig+3), the same
// map for B: ``q`` is the (even) word of pixels 4tig, 4tig+1 in this
// lane's group row. Rows: m-tile 0 = the group's taps kw=0 (rows 0-7) and
// kw=1 (8-15); m-tile 1 = kw=2 (16-23), then the ninth group's tap
// (24-26), whose words start at e + eo and whose kw ``sel`` picks.
__device__ __forceinline__ void load_a(const uint32_t* s, int q, int e, int eo,
                                       int sel, uint32_t (&a)[2][4]) {
  const uint32_t wm = reinterpret_cast<const uint2*>(s + q - 2)->y;
  const uint32_t wp = reinterpret_cast<const uint2*>(s + q + 2)->x;
  const uint2 w = *reinterpret_cast<const uint2*>(s + q);
  const uint32_t u0 = s[e + eo], u1 = s[e + eo + 1], u2 = s[e + eo + 2];
  const uint32_t mid = pair_up(w.x, w.y);  // pixels 4tig+1, 4tig+2
  a[0][0] = pair_up(wm, w.x);  // kw=0: pixels 4tig-1, 4tig
  a[0][1] = w.x;               // kw=1
  a[0][2] = mid;               // kw=0, second pair
  a[0][3] = w.y;
  a[1][0] = mid;               // kw=2: pixels 4tig+1, 4tig+2
  a[1][1] = __byte_perm(u0, u1, sel);
  a[1][2] = pair_up(w.y, wp);  // kw=2, second pair
  a[1][3] = __byte_perm(u1, u2, sel);
}

// row of the A operand that holds tap kw of group G (9 groups of 3 taps)
__device__ __forceinline__ int a_row(int G, int kw) {
  return G < 8 ? G + 8 * kw : 24 + kw;
}

template <typename T>
__device__ __forceinline__ void wgrad_band(const T* __restrict__ g,
                                           const T* __restrict__ st,
                                           const T* __restrict__ dy,
                                           float* __restrict__ part, int B,
                                           int F, int H, int W, int vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using Layout = WgradSmem<T>;
  constexpr int kEpw = Layout::kEpw, kPad = Layout::kPad, V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(W);
  T* ring = reinterpret_cast<T*>(smem);
  T* planes = reinterpret_cast<T*>(smem + L.planes);
  T* gbuf = reinterpret_cast<T*>(smem + L.gbuf);
  T* g0 = reinterpret_cast<T*>(smem + L.g0);
  float* sall = reinterpret_cast<float*>(smem + L.sall);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  const int Wk = L.Wk, RWe = L.RWd * kEpw, SWe = L.SW * kEpw, GPe = L.GPw * kEpw;
  const int band = blockIdx.x, b = blockIdx.y;
  const int h0 = band * kBR, nr = min(kBR, H - h0);
  const int hlo = max(h0 - 1, 0), hhi = min(h0 + kBR + 1, H);
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int nwb = Wk / 16;  // 16-pixel k-blocks a row; warp r takes row r

  // zeros first (Σ_t ȳ starts from frame 0's values): pads, rows outside
  // the image and frame -1 stay so
  for (size_t q = tid; q < L.sall / 16; q += kThreads)
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // element of tile row rr (image row h0-1+rr), pixel w
  auto tix = [&](int rr, int w) { return rr * RWe + kPad + w; };
  auto stage_g = [&](int t) {
    for (int co = 0; co < 3; ++co)
      stage_rows(gbuf + ((t % kGbuf) * 3 + co) * GPe, Wk,
                 g + (((size_t)b * 3 + co) * F + t) * HW + (size_t)h0 * W, W,
                 nr, W, vec);
  };
  auto stage_d = [&](int t) {
    stage_rows(ring + (t % kRing) * SWe + tix(hlo - h0 + 1, 0), RWe,
               dy + ((size_t)b * F + t) * HW + (size_t)hlo * W, W, hhi - hlo,
               W, vec);
  };

  // the static's rows hlo..hhi land interleaved in ring tiles 2..4, are
  // split into one tile per channel, and those ring tiles are zeroed again
  T* sraw = ring + 2 * SWe;
  stage_rows(sraw, 0, st + ((size_t)b * H + hlo) * W * 3, 0, 1,
             (hhi - hlo) * W * 3, vec);
  stage_g(0);
  stage_d(0);
  if (F > 1) stage_d(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int p = tid; p < (hhi - hlo) * W; p += kThreads) {
    const int rr = p / W, w = p - rr * W, e = tix(hlo - h0 + 1 + rr, w);
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) planes[ci * SWe + e] = sraw[p * 3 + ci];
  }
  __syncthreads();
  for (int q = tid; q < 3 * L.SW; q += kThreads)
    reinterpret_cast<uint32_t*>(sraw)[q] = 0u;
  __syncthreads();
  for (int k = 1; k < kAhead; ++k) {  // one group a frame: ȳ k, dynamic k+1
    if (k < F) stage_g(k);
    if (k + 1 < F) stage_d(k + 1);
    cp_async_commit();
  }

  // bf16: this lane's A rows (see load_a), and the static groups' words
  const int kwe = gid < 3 ? gid : 1;  // ninth group's kw; rows 27-31 pad
  const int eo = kwe == 0 ? -1 : 0, sel = kwe == 1 ? 0x3210 : 0x5432;
  const int s_g = (int)(L.planes / 4) + (gid % 3) * L.SW + (gid / 3) * L.RWd;
  const int s_8 = (int)(L.planes / 4) + 2 * L.SW + 2 * L.RWd;  // kh=2, ci=2
  float cd[2][4] = {};
  // fp32: this thread's pixels' dynamic sums, and the static column
  // (co, m = (kh*3+kw)*3+ci) that thread co*27+m owns
  float acc[kBf16 ? 1 : 81] = {};
  float col_a = 0.f, col_f = 0.f, col_l = 0.f;
  const int nsum = 3 * GPe / V;  // 16-byte chunks of a ȳ frame
  float sreg[kSumRegChunks][V];  // this thread's chunks of Σ_t ȳ

  for (int t = 0; t < F; ++t) {
    cp_async_wait<kAhead - 1>();  // ȳ frame t and dynamic frame t+1 have landed
    __syncthreads();  // ... for every thread; frame t-1's buffers are free
    if (t + kAhead < F) stage_g(t + kAhead);
    if (t + kAhead + 1 < F) {
      stage_d(t + kAhead + 1);
    } else if (t + kAhead + 1 == F && F >= kRing) {  // frame F reads as zeros
      uint32_t* z = reinterpret_cast<uint32_t*>(ring + (F % kRing) * SWe);
      for (int q = tid; q < L.SW; q += kThreads) z[q] = 0u;
    }
    cp_async_commit();

    // Σ_t ȳ (and frame 0's copy), chunk by chunk
    const T* gt = gbuf + (t % kGbuf) * 3 * GPe;
#pragma unroll
    for (int i = 0; i < kSumRegChunks; ++i) {
      const int q = tid + i * kThreads;
      if (q < nsum) {
        const uint4 v = reinterpret_cast<const uint4*>(gt)[q];
        if (t == 0) reinterpret_cast<uint4*>(g0)[q] = v;
        float x[V];
        unpack(v, x);
#pragma unroll
        for (int k = 0; k < V; ++k) sreg[i][k] = t == 0 ? x[k] : sreg[i][k] + x[k];
      }
    }
    for (int q = tid + kSumRegChunks * kThreads; q < nsum; q += kThreads) {
      const uint4 v = reinterpret_cast<const uint4*>(gt)[q];
      if (t == 0) reinterpret_cast<uint4*>(g0)[q] = v;
      float x[V];
      unpack(v, x);
      for (int k = 0; k < V; ++k) sall[q * V + k] = t == 0 ? x[k] : sall[q * V + k] + x[k];
    }

    if constexpr (kBf16) {
      // dynamic group gid = (kt, kh): tile of frame t+kt-1, row kh; the
      // ninth group is (kt=2, kh=2)
      const int kt = gid / 3;
      const int d_g = ((t + kt + kRing - 1) % kRing) * L.SW + (gid - kt * 3) * L.RWd;
      const int d_8 = ((t + 1) % kRing) * L.SW + 2 * L.RWd;
      const uint32_t* gw = reinterpret_cast<const uint32_t*>(gt);
      for (int r = warp; r < nr; r += kWarps) {
        const int rq = r * L.RWd + kPad / 2 + 2 * tig;
        const int rb = gid * L.GPw + r * Wk / 2 + 2 * tig;
        for (int wb = 0; wb < nwb; ++wb) {
          // B: ȳ[co = gid] at pixels 4tig .. 4tig+3 of the block
          const uint2 bv = gid < 3 ? *reinterpret_cast<const uint2*>(gw + rb + 8 * wb)
                                   : make_uint2(0u, 0u);
          const int q = rq + 8 * wb;
          uint32_t a[2][4];
          load_a(words, d_g + q, d_8 + q, eo, sel, a);
          mma_bf16(cd[0], a[0], bv.x, bv.y);
          mma_bf16(cd[1], a[1], bv.x, bv.y);
        }
      }
    } else {
      for (int p = tid; p < nr * W; p += kThreads) {
        const int r = p / W, w = p - r * W;
        float gv[3];
#pragma unroll
        for (int co = 0; co < 3; ++co) gv[co] = to_f<T>(gt[co * GPe + r * Wk + w]);
#pragma unroll
        for (int kt = 0; kt < 3; ++kt) {
          const T* base = ring + ((t + kt + kRing - 1) % kRing) * SWe + tix(r, w) - 1;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const float v = to_f<T>(base[(k / 3) * RWe + k % 3]);
#pragma unroll
            for (int co = 0; co < 3; ++co) acc[(kt * 9 + k) * 3 + co] += gv[co] * v;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSumRegChunks; ++i) {
    const int q = tid + i * kThreads;
    if (q < nsum)
#pragma unroll
      for (int k = 0; k < V; ++k) sall[q * V + k] = sreg[i][k];
  }
  __syncthreads();  // Σ_t ȳ and the copy of frame 0 complete

  // reduction scratch over the tiles, [type: dyn, A, Bf, Bl][warp][A row
  // 32][co 4] then [warp][co] for the bias: the dynamic sums go in now
  // (over the ring, which is done with), the static ones after their pass
  float* red = reinterpret_cast<float*>(smem);
  float* redb = red + kRedFloats;
  auto at = [&](int type, int w, int m, int co) -> float& {
    return red[((type * kWarps + w) * 32 + m) * 4 + co];
  };
  if constexpr (kBf16) {
    if (tig < 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          at(0, warp, mt * 16 + gid + (q >= 2 ? 8 : 0), 2 * tig + (q & 1)) = cd[mt][q];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 81; ++j) {  // j = (kt*9 + kh*3 + kw)*3 + co
      float s = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int tap = j / 3, kt = tap / 9, kh = (tap / 3) % 3;
      if (lane == 0) at(0, warp, a_row(kt * 3 + kh, tap % 3), j % 3) = s;
    }
  }

  // the static products with frame 0 (Bf), frame F-1 (Bl) and Σ_t ȳ (A),
  // and the bias's Σ ȳ
  const T* gl = gbuf + ((F - 1) % kGbuf) * 3 * GPe;
  float cf[2][4] = {}, cl[2][4] = {}, ca[2][4] = {};
  float bsum = 0.f;
  if constexpr (kBf16) {
    for (int kb = warp; kb < nr * nwb; kb += kWarps) {
      const int r = kb / nwb, w0 = (kb - r * nwb) * 16;
      uint2 bf = make_uint2(0u, 0u), bl = bf;
      uint32_t bh0 = 0u, bh1 = 0u, bl0 = 0u, bl1 = 0u;
      if (gid < 3) {
        const int e = (gid * GPe + r * Wk + w0) / 2 + 2 * tig;
        bf = reinterpret_cast<const uint2*>(g0)[e / 2];
        bl = reinterpret_cast<const uint2*>(gl)[e / 2];
        const float4 s4 = *reinterpret_cast<const float4*>(
            sall + gid * GPe + r * Wk + w0 + 4 * tig);
        const float v[4] = {s4.x, s4.y, s4.z, s4.w};
        uint32_t hb[4], lb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bsum += v[k];
          hb[k] = bf_bits(v[k]);
          lb[k] = bf_bits(v[k] - __uint_as_float(hb[k] << 16));
        }
        bh0 = hb[0] | hb[1] << 16;
        bh1 = hb[2] | hb[3] << 16;
        bl0 = lb[0] | lb[1] << 16;
        bl1 = lb[2] | lb[3] << 16;
      }
      const int q = r * L.RWd + (kPad + w0) / 2 + 2 * tig;
      uint32_t a[2][4];
      load_a(words, s_g + q, s_8 + q, eo, sel, a);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(cf[mt], a[mt], bf.x, bf.y);
        mma_bf16(cl[mt], a[mt], bl.x, bl.y);
        mma_bf16(ca[mt], a[mt], bh0, bh1);
        mma_bf16(ca[mt], a[mt], bl0, bl1);
      }
    }
    bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
    bsum += __shfl_xor_sync(0xffffffffu, bsum, 2);
  } else if (tid < 84) {  // threads 81-83: the bias of co = tid-81
    const int co = tid < 81 ? tid / 27 : tid - 81, m = tid % 27;
    const T* sp = planes + (m % 3) * SWe + tix(m / 9, (m / 3) % 3 - 1);
    for (int r = 0; r < nr; ++r)
      for (int w = 0; w < W; ++w) {
        const int e = co * GPe + r * Wk + w;
        const float v = tid < 81 ? to_f<T>(sp[r * RWe + w]) : 1.f;
        col_a += sall[e] * v;
        col_f += to_f<T>(g0[e]) * v;
        col_l += to_f<T>(gl[e]) * v;
      }
    if (tid >= 81) bsum = col_a;
  }

  // the static sums into the scratch (over the static tiles, after every
  // warp is done with them); then thread j sums column j over the warps in
  // a fixed order (fp32: one column thread, warp 0's slot)
  __syncthreads();
  constexpr int kStaticWarps = kBf16 ? kWarps : 1;
  if constexpr (kBf16) {
    if (tig < 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = mt * 16 + gid + (q >= 2 ? 8 : 0), n = 2 * tig + (q & 1);
          at(1, warp, m, n) = ca[mt][q];
          at(2, warp, m, n) = cf[mt][q];
          at(3, warp, m, n) = cl[mt][q];
        }
    }
    if (tig == 0 && gid < 3) redb[warp * 3 + gid] = bsum;
  } else if (tid < 81) {
    const int co = tid / 27, m = tid - co * 27, ci = m % 3, kh = m / 9;
    const int row = a_row(kh * 3 + ci, (m / 3) % 3);
    at(1, 0, row, co) = col_a;
    at(2, 0, row, co) = col_f;
    at(3, 0, row, co) = col_l;
  } else if (tid < 84) {
    redb[tid - 81] = bsum;
  }
  __syncthreads();
  for (int j = tid; j < kNWB; j += kThreads) {
    float v = 0.f;
    if (j < kNW) {
      const int co = j % 3, ci = (j / 3) % 4, tap = j / 12;
      const int kt = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      if (ci == 3) {
        const int row = a_row(kt * 3 + kh, kw);
        for (int w = 0; w < kWarps; ++w) v += at(0, w, row, co);
      } else {
        // kt=1 sees every frame (A); kt=0 misses frame 0 (A - Bf); kt=2
        // misses frame F-1 (A - Bl)
        const int row = a_row(kh * 3 + ci, kw);
        float e = 0.f;
        for (int w = 0; w < kStaticWarps; ++w) v += at(1, w, row, co);
        if (kt != 1)
          for (int w = 0; w < kStaticWarps; ++w) e += at(kt == 0 ? 2 : 3, w, row, co);
        v -= e;
      }
    } else {
      for (int w = 0; w < kStaticWarps; ++w) v += redb[w * 3 + j - kNW];
    }
    part[((size_t)band * B + b) * kNWB + j] = v;
  }
}

// 3 blocks of 256 threads an SM: at most 85 registers a thread
__global__ void __launch_bounds__(kThreads, 3)
hal_wgrad_band_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ st,
                           const __nv_bfloat16* __restrict__ dy,
                           float* __restrict__ part, int B, int F, int H,
                           int W, int vec) {
  wgrad_band(g, st, dy, part, B, F, H, W, vec);
}

__global__ void __launch_bounds__(kThreads)
hal_wgrad_band_f32_kernel(const float* __restrict__ g,
                          const float* __restrict__ st,
                          const float* __restrict__ dy,
                          float* __restrict__ part, int B, int F, int H, int W,
                          int vec) {
  wgrad_band(g, st, dy, part, B, F, H, W, vec);
}

inline auto wgrad_kernel(const __nv_bfloat16*) { return hal_wgrad_band_bf16_kernel; }
inline auto wgrad_kernel(const float*) { return hal_wgrad_band_f32_kernel; }

// wgrad, pass 2: block j sums column j over all rows in a fixed order.
__global__ void __launch_bounds__(kThreads)
hal_wgrad_finish_kernel(const float* __restrict__ part, int rows,
                        float* __restrict__ out) {
  __shared__ float red[kThreads / 32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s += part[(size_t)r * kNWB + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) tot += red[k];
    out[j] = tot;
  }
}

// ---------------------------------------------------------------------------
// dgrad: dd[b, t, h, w] (optional) and ds[b, h, w, ci] (optional) from ȳ.
//
// dd is the 27-tap flipped stencil of ȳ summed over the 3 output channels:
// ȳ frame t at (h+1-kh, w+1-kw) feeds dd frames t-1 (kt=0), t (kt=1) and
// t+1 (kt=2). The old kernel (a thread a pixel, 27 scalar 2-byte global
// loads a pixel-frame behind bounds checks) was bound by load issue at 11%
// of its byte bound. Here a block per (band of kDR rows, column band of at
// most kDCW pixels, sample) streams the F frames of ȳ through a ring of
// kDRing shared-memory tiles, so ȳ is read from DRAM once (the halo rows
// from L2). A producer warp fills the ring with bulk copies (the copy
// engine, a row of a co plane each) that complete on a "full" mbarrier per
// slot; the 8 consumer warps wait on it, compute, and release the slot on
// an "empty" mbarrier. No block-wide barrier a frame: each warp runs ahead
// as far as the data allows. A tile holds the three co planes of kDR+2
// rows (a one-row halo each side) and the band's columns with 8 more each
// side; what lies outside the image stays zero, so the stencil has no
// bounds checks. Rows that are not 16-byte multiples, or an unaligned ȳ,
// are copied element by element by the producer's lanes instead.
//
// bf16: the taps are mma.sync.m16n8k16 products, exact in fp32:
//   A = 16 pixels x K, B = K x 8 weight columns, D = 16 pixels x 8.
// The A operand is a shifted view of the tile. Instead of staging shifted
// copies (an extra shared-memory pass a frame) or byte permutes, the pixels
// of one mma share a parity: rows gid and gid+8 are pixels of two
// neighbouring image rows at the same column. For an even pixel x the
// aligned word (x,x+1) holds taps kw=1,0 and the word (x-2,x-1) tap kw=2
// beside a zero weight; for an odd x the words (x-1,x) and (x+1,x+2). So
// K is, per kh, one word pair per co (lane tig reads plane co=tig; tig=3
// reads a zero row), and the even and odd mmas share the middle word. A
// lane owns 8 neighbouring pixels (4 pixel pairs) of its two rows, so one
// 16-byte and two 4-byte loads a row feed 8 mmas per kh. B carries the
// parity's weights; its columns are dd frames mod 3, so that frame t's kt
// tap lands in column (t-1+kt) mod 3 and each column keeps its running sum
// in the mma accumulators across the three frames it receives: no
// shuffles, and with the frame loop unrolled by three the finished column
// is known at compile time. The B fragments for frame t come from a table
// in shared memory. Weights that are not bf16 values (fp32 weights with
// bf16 ȳ) add a second mma with their bf16 remainder. Two warps share a
// row pair of the band, one 64-pixel unit each. The lanes that hold a
// finished column store their 8 pixels of a row as one 16-byte store.
// fp32: the same tiles on FFMA (TF32 would change the result), a thread
// owning fixed pixels of the band with three running sums each.
// ds: Σ_t ȳ (fp32) and a copy of frame 0 build up in shared memory as the
// frames pass; the static's flipped 2-D stencils run on them, frame 0 and
// frame F-1 once at the end, so ȳ is read once for both outputs.
// ---------------------------------------------------------------------------
constexpr int kDR = 8;      // rows a dgrad block: 4 row pairs, 2 warps each
constexpr int kDCW = 112;   // most columns a dgrad block (2 units of 64)
constexpr int kDOff = 8;    // tile element p holds image column cx0 - kDOff + p
constexpr int kDAhead = 3;  // ȳ frames the producer may run ahead of the consumers
constexpr int kDRing = kDAhead + 1;
constexpr int kDRows = kDR + 2;
constexpr int kDFp = (kDR * kDCW + kThreads - 1) / kThreads;  // fp32 pixels a thread
constexpr int kDThreads = kThreads + 32;  // 8 consumer warps and a producer
static_assert(kDR == kWarps, "two warps a row pair of a dgrad band");

// shared-memory layout of a dgrad block, the same on the host and the
// device: the ring of ȳ tiles at 0 (a tile: 3 planes of kDRows rows of RWe
// elements; element p of a row is image column cx0 - kDOff + p), a zero row,
// then [bf16] the B table, then [ds] Σ_t ȳ and frame 0, then the mbarriers.
template <typename T>
struct DgradSmem {
  static constexpr int kEpw = 4 / sizeof(T);
  int CW, RWw, RWe, PS, PSe, SL;  // columns; a row in words, elements; a plane; a tile (words)
  size_t zero, btab, sums, f0, bars, total;  // byte offsets
  __host__ __device__ DgradSmem(int W, bool with_s) {
    CW = (W < kDCW ? W : kDCW);
    CW = (CW + 15) / 16 * 16;
    RWw = ((2 * 64 + 16) / kEpw + 31) / 32 * 32;  // two units; rows 0 mod 32 words apart
    RWe = RWw * kEpw;
    PS = kDRows * RWw + 8;  // planes 8 banks apart
    PSe = PS * kEpw;
    SL = (3 * PS + 31) / 32 * 32;
    zero = ((size_t)kDRing * SL + 24) * 4;  // 24 banks past the tiles
    btab = ((size_t)kDRing * SL + 24 + RWw + 31) / 32 * 32 * 4;
    sums = btab + (sizeof(T) == 2 ? (size_t)2 * 72 * 8 : 0);
    f0 = sums + (with_s ? (size_t)3 * PSe * 4 : 0);
    bars = (f0 + (with_s ? (size_t)SL * 4 : 0) + 7) / 8 * 8;
    total = bars + (size_t)2 * kDRing * 8;  // full and empty mbarriers
  }
};

// 16 bytes from shared memory (p 16-byte aligned)
__device__ __forceinline__ void lds128(uint32_t* v, const uint32_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t bf_pair(float lo, float hi) {
  return bf_bits(lo) | bf_bits(hi) << 16;
}

// remainder of v after rounding to bf16
__device__ __forceinline__ float bf_rest(float v) {
  return v - __uint_as_float(bf_bits(v) << 16);
}

template <int N> using Phase = std::integral_constant<int, N>;

// mbarriers in shared memory (8 bytes each) and the bulk copy that
// completes on one
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// bytes (a multiple of 16; both ends 16-byte aligned) from global to
// shared memory by the copy engine, counted on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's generic-proxy writes to shared memory before the async
// proxy's (the bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dd alone: 2 blocks an SM (at most 113 registers); with ds, whose frame
// sums would spill there, one block's registers are not capped
template <typename T, int kS>
__global__ void __launch_bounds__(kDThreads, kS ? 1 : 2)
hal_dgrad_kernel(const T* __restrict__ g, const float* __restrict__ wb,
                 T* __restrict__ ds, T* __restrict__ dd, int F, int H, int W,
                 int vec_in, int vec_out) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using Layout = DgradSmem<T>;
  __shared__ float sw[kNWB];
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(W, kS != 0);
  const int RWe = L.RWe, PSe = L.PSe, SLe = L.SL * Layout::kEpw;
  T* ring = reinterpret_cast<T*>(smem);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // slot s holds frame t
  uint64_t* empty = full + kDRing;                               // slot s is read
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ncb = (W + kDCW - 1) / kDCW;
  const int rb = blockIdx.x / ncb, cb = blockIdx.x - rb * ncb;
  const int h0 = rb * kDR, cx0 = cb * kDCW;
  const int nr = min(kDR, H - h0), CW = min(kDCW, W - cx0);
  const int b = blockIdx.y;
  const size_t HW = (size_t)H * W;
  const bool need_d = dd != nullptr;

  for (int i = tid; i < kNWB; i += kDThreads) sw[i] = wb[i];
  // zeros: tiles (pads, rows and columns outside the image stay so) and
  // the zero row
  for (size_t q = tid; q < L.btab / 16; q += kDThreads)
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kDRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // B table (bf16): [hi | lo][kt][kh][par][tig] -> (b0, b1); see above
  bool rest = false;
  if constexpr (kBf16) {
    uint2* bt = reinterpret_cast<uint2*>(smem + L.btab);
    if (tid < 72) {
      const int tg = tid & 3, par = (tid >> 2) & 1, kh = (tid >> 3) % 3, kt = tid / 24;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f;
      if (tg < 3) {
        w0 = sw[widx(kt, kh, 0, 3, tg)];
        w1 = sw[widx(kt, kh, 1, 3, tg)];
        w2 = sw[widx(kt, kh, 2, 3, tg)];
      }
      const float r0 = bf_rest(w0), r1 = bf_rest(w1), r2 = bf_rest(w2);
      rest = r0 != 0.f || r1 != 0.f || r2 != 0.f;
      bt[tid] = par == 0 ? make_uint2(bf_pair(w1, w0), bf_pair(0.f, w2))
                         : make_uint2(bf_pair(w2, w1), bf_pair(w0, 0.f));
      bt[72 + tid] = par == 0 ? make_uint2(bf_pair(r1, r0), bf_pair(0.f, r2))
                              : make_uint2(bf_pair(r2, r1), bf_pair(r0, 0.f));
    }
  }
  const bool use_rest = __syncthreads_or(rest);

  if (warp == kWarps) {
    // the producer warp: ȳ frame t into ring slot t % kDRing, once the
    // consumers are done with frame t - kDRing there: the rows hlo..hhi-1
    // and columns xlo..xhi-1 the band reads that lie inside the image
    const int hlo = max(h0 - 1, 0), hhi = min(h0 + kDR + 1, H);
    const int xlo = max(cx0 - 8, 0), xhi = min(cx0 + CW + 8, W);
    const int nrows = hhi - hlo, ncols = xhi - xlo;
    fence_proxy_async();  // the zeros before the copies
    for (int t = 0; t < F; ++t) {
      const int s = t % kDRing;
      if (t >= kDRing) mbar_wait(&empty[s], (t / kDRing - 1) & 1);
      T* slot = ring + (size_t)s * SLe + (hlo - h0 + 1) * RWe + (xlo - cx0 + kDOff);
      const T* src = g + ((size_t)b * 3 * F + t) * HW + (size_t)hlo * W + xlo;
      if (vec_in) {  // a bulk copy a (co, row)
        if (lane == 0) mbar_arrive_expect_tx(&full[s], 3 * nrows * ncols * (int)sizeof(T));
        __syncwarp();
        for (int k = lane; k < 3 * nrows; k += 32) {
          const int co = k / nrows, r = k - co * nrows;
          bulk_copy(slot + co * PSe + r * RWe, src + (size_t)co * F * HW + (size_t)r * W,
                    ncols * sizeof(T), &full[s]);
        }
      } else {  // element by element
        for (int k = 0; k < 3 * nrows; ++k) {
          const int co = k / nrows, r = k - co * nrows;
          T* d = slot + co * PSe + r * RWe;
          const T* sp = src + (size_t)co * F * HW + (size_t)r * W;
          for (int c = lane; c < ncols; c += 32) d[c] = sp[c];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
  } else {
    // the consumer warps. bf16: the warp's rows r0, r0+1 and unit u
    // (columns 64u ..); lane gid's pixel pairs 64u + 8gid + 2k, k < 4, even
    // and odd accumulators; this lane's plane (tig = 3: the zero row)
    float acc[4][2][4] = {};
    const int r0 = 2 * (warp >> 1), unit = warp & 1;
    const int xs = 64 * unit + 8 * gid;  // the lane's first pixel
    const int lane_plane = tig < 3 ? tig * L.PS : 0;
    const int lane_row = tig < 3 ? L.RWw : 0;
    const int zero_w = (int)(L.zero / 4);
    T* ddw = need_d ? dd + ((size_t)b * F * H + h0 + r0) * W + cx0 + xs : nullptr;
    // fp32: pixel q = tid + i*kThreads of the band, three running sums
    float fa[kDFp][3] = {};

    // bf16: dd frame tt's 8 pixels xs .. xs+7 of band row r0+rr, from the
    // accumulator entries e of the even and odd pixels
    auto store8 = [&](int tt, int rr, int e) {
      if (r0 + rr >= nr || xs >= CW) return;
      T* p = ddw + (size_t)tt * HW + rr * W;
      if (vec_out && xs + 8 <= CW) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4(bf_pair(acc[0][0][e], acc[0][1][e]), bf_pair(acc[1][0][e], acc[1][1][e]),
                       bf_pair(acc[2][0][e], acc[2][1][e]), bf_pair(acc[3][0][e], acc[3][1][e]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int par = 0; par < 2; ++par)
            if (xs + 2 * k + par < CW) p[2 * k + par] = from_f<T>(acc[k][par][e]);
      }
    };
    // bf16: store the finished column c (dd frame tt, when tt >= 0) and
    // zero it for the frame it takes next
    auto finish = [&](int tt, auto col) {
      constexpr int c = decltype(col)::value, s = c & 1;
      if (tig != (c >> 1)) return;
      if (tt >= 0) {
        store8(tt, 0, s);
        store8(tt, 1, 2 + s);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          acc[k][par][s] = 0.f;
          acc[k][par][2 + s] = 0.f;
        }
    };

    // frame t, t % 3 == P
    auto frame = [&](int t, auto phase) {
      constexpr int P = decltype(phase)::value;
      const int sl = t % kDRing;
      mbar_wait(&full[sl], (t / kDRing) & 1);  // frame t has landed
      const T* slot = ring + (size_t)sl * SLe;

      if constexpr (kS != 0) {  // Σ_t ȳ in fp32, in frame order, and frame 0
        float* sums = reinterpret_cast<float*>(smem + L.sums);
        T* f0 = reinterpret_cast<T*>(smem + L.f0);
        for (int q = tid; q < 3 * PSe; q += kThreads) {
          const float v = to_f<T>(slot[q]);
          if (t == 0) {
            sums[q] = v;
            f0[q] = slot[q];
          } else {
            sums[q] += v;
          }
        }
      }

      if (!need_d) {
      } else if constexpr (kBf16) {
        // this frame's B: lane gid < 3 holds column gid = dd frame mod 3,
        // fed by tap kt = (gid - t + 1) mod 3
        const uint2* bt = reinterpret_cast<const uint2*>(smem + L.btab);
        const int kt = (gid + 4 - P) % 3;
        uint2 bh[3][2];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int par = 0; par < 2; ++par)
            bh[kh][par] = gid < 3 ? bt[((kt * 3 + kh) * 2 + par) * 4 + tig] : make_uint2(0u, 0u);
        const int sw0 = sl * L.SL;
        // words q-1 .. q+4 of a tile row, q (0 mod 4) the word of pixels
        // xs, xs+1: one 16-byte load and two 4-byte ones
        const int q = (xs + kDOff) / 2;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          // tile row of image row h0+r0+1-kh (rows gid); rows gid+8 the next
          const int base = tig < 3 ? sw0 + lane_plane + (r0 + 2 - kh) * L.RWw : zero_w;
          uint32_t x0[6], x1[6];
          lds128(x0 + 1, words + base + q);
          x0[0] = words[base + q - 1];
          x0[5] = words[base + q + 4];
          lds128(x1 + 1, words + base + lane_row + q);
          x1[0] = words[base + lane_row + q - 1];
          x1[5] = words[base + lane_row + q + 4];
          uint2 bl[2];
          if (use_rest)
#pragma unroll
            for (int par = 0; par < 2; ++par)
              bl[par] = gid < 3 ? bt[72 + ((kt * 3 + kh) * 2 + par) * 4 + tig] : make_uint2(0u, 0u);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // pixel pair k: words q+k (pixels xs+2k, +1), q+k-1 and q+k+1
            const uint32_t ae[4] = {x0[k + 1], x1[k + 1], x0[k], x1[k]};
            const uint32_t ao[4] = {x0[k + 1], x1[k + 1], x0[k + 2], x1[k + 2]};
            mma_bf16(acc[k][0], ae, bh[kh][0].x, bh[kh][0].y);
            mma_bf16(acc[k][1], ao, bh[kh][1].x, bh[kh][1].y);
            if (use_rest) {
              mma_bf16(acc[k][0], ae, bl[0].x, bl[0].y);
              mma_bf16(acc[k][1], ao, bl[1].x, bl[1].y);
            }
          }
        }
        finish(t - 1, Phase<(P + 2) % 3>());  // dd frame t-1
      } else {
#pragma unroll
        for (int i = 0; i < kDFp; ++i) {
          const int q = tid + i * kThreads;
          if (q >= kDR * CW) continue;
          const int r = q / CW, x = q - r * CW;
          const T* base = slot + (r + 2) * RWe + x + kDOff + 1;  // image row h0+r+1, column x+1
          float a0 = fa[i][0], a1 = fa[i][1], a2 = 0.f;
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
#pragma unroll
              for (int co = 0; co < 3; ++co) {
                const float v = to_f<T>(base[co * PSe - kh * RWe - kw]);
                a0 += sw[widx(0, kh, kw, 3, co)] * v;
                a1 += sw[widx(1, kh, kw, 3, co)] * v;
                a2 += sw[widx(2, kh, kw, 3, co)] * v;
              }
          if (t >= 1 && r < nr)
            dd[((size_t)b * F + t - 1) * HW + (size_t)(h0 + r) * W + cx0 + x] = from_f<T>(a0);
          fa[i][0] = a1;
          fa[i][1] = a2;
        }
      }
      __syncwarp();  // the warp is done with slot sl
      if (lane == 0) mbar_arrive(&empty[sl]);
    };
    for (int t = 0; t < F; t += 3) {
      frame(t, Phase<0>());
      if (t + 1 < F) frame(t + 1, Phase<1>());
      if (t + 2 < F) frame(t + 2, Phase<2>());
    }

    if (need_d) {  // dd frame F-1
      if constexpr (kBf16) {
        const int c = (F - 1) % 3;
        if (c == 0) finish(F - 1, Phase<0>());
        else if (c == 1) finish(F - 1, Phase<1>());
        else finish(F - 1, Phase<2>());
      } else {
#pragma unroll
        for (int i = 0; i < kDFp; ++i) {
          const int q = tid + i * kThreads;
          if (q >= kDR * CW) continue;
          const int r = q / CW, x = q - r * CW;
          if (r < nr)
            dd[((size_t)b * F + F - 1) * HW + (size_t)(h0 + r) * W + cx0 + x] =
                from_f<T>(fa[i][0]);
        }
      }
    }
  }

  if constexpr (kS != 0) {
    // the static input at (h, w) reaches every frame: per neighbour, the
    // temporal sums of ȳ over the frames each kt tap is valid for
    __syncthreads();
    const float* sums = reinterpret_cast<const float*>(smem + L.sums);
    const T* f0 = reinterpret_cast<const T*>(smem + L.f0);
    const T* fl = ring + (size_t)((F - 1) % kDRing) * SLe;
    for (int q = tid; q < nr * CW; q += kDThreads) {

      const int r = q / CW, x = q - r * CW;
      const int e0 = (r + 2) * RWe + x + kDOff + 1;
      float acc3[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int co = 0; co < 3; ++co) {
            const int e = e0 + co * PSe - kh * RWe - kw;
            const float s_all = sums[e];
            const float t0 = s_all - to_f<T>(f0[e]);  // kt=0: t >= 1
            const float t2 = s_all - to_f<T>(fl[e]);  // kt=2: t <= F-2
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
              acc3[ci] += sw[widx(0, kh, kw, ci, co)] * t0 +
                          sw[widx(1, kh, kw, ci, co)] * s_all +
                          sw[widx(2, kh, kw, ci, co)] * t2;
          }
      T* dsp = ds + (((size_t)b * H + h0 + r) * W + cx0 + x) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) dsp[ci] = from_f<T>(acc3[ci]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: y[b, co, t, h, w], the design in the note at the top of the file
// ---------------------------------------------------------------------------
constexpr int kFCW = 128;      // most columns a forward block
constexpr int kFSlots = 3;     // dynamic frames in shared memory: t, t+1, t+2
constexpr int kFThreads = 256; // most threads a forward block

// The weights and biases of the launch in flight, copied from the caller's
// buffer on the launch's stream just before it: each FFMA takes its weight
// from the constant bank, with no load. Forward launches on two streams must
// therefore not overlap.
__constant__ float c_fwd_w[kNWB];

__device__ __forceinline__ float fw(int i) { return c_fwd_w[i]; }

// Work split: a thread owns V neighbouring pixels of a row (a "run"), and
// a column band's runs are numbered row-major over all samples' rows; a
// block owns nt consecutive runs. Blocks of 8 full warps at any width keep
// the SM's four schedulers equally busy (whole rows of 112 pixels would
// give 7). A block's runs span at most rows_max image rows, which may
// belong to more than one sample.
//
// Shared memory, the same layout on the host and the device: the ring of
// kFSlots dynamic tiles at 0, then the static's rows as they lie in memory
// (pixel-interleaved), whose space holds a record a thread (its pixels'
// base and u2) once the static stencils are taken. A tile row holds one
// image row: the block's rows in order, each sample's rows between a zero
// row above and below (its halo rows outside the image), so that a window
// never reaches into another sample. Element C + x of a tile row holds
// column cx0 + x, x in [-C, TPR*V + C), C being a 16-byte copy's elements.
// Tile rows are 128 bytes longer than a band's pixels, so that the window
// loads of a warp's lanes, consecutive runs of consecutive rows, fall in
// consecutive banks (no conflicts). A static row holds the same columns,
// three elements each. Last, the list of a frame's 16-byte copies.
template <typename T>
struct FwdSmem {
  static constexpr int C = 16 / sizeof(T);          // elements a 16-byte copy
  static constexpr int V = sizeof(T) == 2 ? 8 : 4;  // pixels a run
  // a thread's record: base then u2, 3 x V floats each; records 6V + 4
  // words apart keep 8 lanes' 16-byte loads in 8 different bank quads
  static constexpr int kRec = 6 * V + 4;
  int TPR, nt, rows_max, Rt, RS, PS, SR;  // runs a row, threads; rows, tile rows; elements
  size_t stat, zero, list, total;          // byte offsets; zeros end at zero
  __host__ __device__ FwdSmem(int H, int W) {
    TPR = ((W < kFCW ? W : kFCW) + V - 1) / V;
    nt = 32 * TPR < kFThreads ? 32 * TPR : kFThreads;
    rows_max = (nt - 1) / TPR + 2;
    int samples = (rows_max - 1) / H + 2;
    samples = samples < rows_max ? samples : rows_max;
    Rt = rows_max + 2 * samples;
    RS = TPR * V + 128 / (int)sizeof(T);
    PS = Rt * RS;
    SR = (TPR * V + 2 * C) * 3;
    stat = (size_t)kFSlots * PS * sizeof(T);
    const size_t rows = (size_t)Rt * SR * sizeof(T);
    const size_t recs = (size_t)kRec * nt * sizeof(float);
    zero = stat + rows;
    list = stat + (rows > recs ? rows : recs);
    // a frame's 16-byte copies: rows_max + 2 image rows of at most TPR*V + 2C columns
    total = list + (size_t)(rows_max + 2) * ((TPR * V + 2 * C) / C) * sizeof(uint2);
  }
};

// a window row in fp32: columns x-1 .. x+V around the thread's pixels
// x .. x+V-1 at p (aligned to their size in shared memory)
__device__ __forceinline__ void load_win(const __nv_bfloat16* p, float (&v)[10]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  float x[8];
  unpack(*reinterpret_cast<const uint4*>(w), x);
  v[0] = bf_hi(w[-1]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i + 1] = x[i];
  v[9] = bf_lo(w[4]);
}
__device__ __forceinline__ void load_win(const __nv_bfloat16* p, float (&v)[6]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  const uint2 m = *reinterpret_cast<const uint2*>(w);
  v[0] = bf_hi(w[-1]);
  v[1] = bf_lo(m.x); v[2] = bf_hi(m.x); v[3] = bf_lo(m.y); v[4] = bf_hi(m.y);
  v[5] = bf_lo(w[2]);
}
__device__ __forceinline__ void load_win(const float* p, float (&v)[6]) {
  const float4 m = *reinterpret_cast<const float4*>(p);
  v[0] = p[-1];
  v[1] = m.x; v[2] = m.y; v[3] = m.z; v[4] = m.w;
  v[5] = p[4];
}

// the thread's V values at p, rounded once, as one store
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store_px(__nv_bfloat16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf2(x[0], x[1]), bf2(x[2], x[3]), bf2(x[4], x[5]), bf2(x[6], x[7]));
}
__device__ __forceinline__ void store_px(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf2(x[0], x[1]), bf2(x[2], x[3]));
}
__device__ __forceinline__ void store_px(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// kVec: the dynamic's rows are 16-byte multiples and start 16-byte aligned
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFThreads, 2)
hal_fwd_kernel(const T* __restrict__ st, const T* __restrict__ dy,
               T* __restrict__ y, int B, int F, int H, int W, int vec_st,
               int vec_out) {
  using Layout = FwdSmem<T>;
  constexpr int C = Layout::C, V = Layout::V, kRec = Layout::kRec;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H, W);
  const int TPR = L.TPR, RS = L.RS, PS = L.PS, SR = L.SR, nt = L.nt;
  T* ring = reinterpret_cast<T*>(smem);
  T* srows = reinterpret_cast<T*>(smem + L.stat);
  const int tid = threadIdx.x;
  const int ncb = (W + kFCW - 1) / kFCW;
  const int cb = blockIdx.x % ncb, cx0 = cb * kFCW, CW = min(kFCW, W - cx0);
  const size_t HW = (size_t)H * W;
  // the block's runs k0 .. k0+nt-1 (of nk < 2^31), rows g_first .. g_last
  // counted over all samples, samples bA .. bZ
  const int nk = B * H * TPR, k0 = (int)(blockIdx.x / ncb) * nt;
  const int g_first = k0 / TPR, g_last = (min(k0 + nt, nk) - 1) / TPR;
  const int bA = g_first / H, bZ = g_last / H;
  // this thread's run: row g (sample b, row h), runs c of the band; its
  // window's top tile row (image row h-1) starts at element e0
  const int k = k0 + tid;
  const bool active = k < nk;
  const int g = active ? k / TPR : g_first;
  const int c = k - g * TPR, b = g / H, h = g - b * H;
  const int e0 = (g - g_first + 2 * (b - bA)) * RS + C + V * c;

  // zeros: what lies outside the image stays so
  for (int q = tid; q < (int)(L.zero / 16); q += nt)
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // The image rows the block reads are n = 0 .. nrows-1, row g_first-1+n:
  // its output rows and the rows above and below them, those of the first
  // and the last sample only. Row n's sample is bA + db, its tile row
  // n + 2 db, and -1 marks a row that is not read.
  const int nrows = g_last - g_first + 3;
  auto row_of = [&](int n, int& db, int& hh) {
    const int gg = g_first - 1 + n;
    if (gg < 0 || gg >= B * H) return -1;
    const int bb = gg / H;
    if ((n == 0 && bb != bA) || (n == nrows - 1 && bb != bZ)) return -1;
    db = bb - bA;
    hh = gg - bb * H;
    return n + 2 * db;
  };
  const int xlo = max(cx0 - C, 0), xhi = min(cx0 + TPR * V + C, W), ncols = xhi - xlo;
  const int col0 = C + xlo - cx0;  // tile element of column xlo
  const T* dyA = dy + (size_t)bA * F * HW + xlo;
  // kVec: the list of a frame's 16-byte copies, (source offset in a frame
  // of dyA, tile offset), built once; ~0u marks a row that is not read
  uint2* list = reinterpret_cast<uint2*>(smem + L.list);
  const int per = ncols / C, nch = kVec ? nrows * per : 0;
  for (int q = tid; q < nch; q += nt) {
    const int n = q / per, cc = (q - n * per) * C;
    int db, hh;
    const int tr = row_of(n, db, hh);
    list[q] = tr < 0 ? make_uint2(~0u, 0u)
                     : make_uint2((uint32_t)(((size_t)db * F * H + hh) * W + cc),
                                  (uint32_t)(tr * RS + col0 + cc));
  }
  __syncthreads();
  // dynamic frame t into ring slot s: 16 bytes a cp.async from the list,
  // else element by element (rows not 16-byte multiples, or an unaligned
  // input)
  auto stage = [&](int t, int s) {
    T* slot = ring + s * PS;
    const T* src = dyA + (size_t)t * HW;
    if constexpr (kVec) {
      for (int q = tid; q < nch; q += nt) {
        const uint2 e = list[q];
        if (e.x != ~0u) cp_async16(slot + e.y, src + e.x);
      }
    } else {
      for (int q = tid; q < nrows * ncols; q += nt) {
        const int n = q / ncols, cc = q - n * ncols;
        int db, hh;
        const int tr = row_of(n, db, hh);
        if (tr >= 0) slot[tr * RS + col0 + cc] = src[((size_t)db * F * H + hh) * W + cc];
      }
    }
  };
  // the static's rows as they lie in memory, 16 bytes a cp.async where
  // vec_st, else element by element; then frames 0 and 1
  {
    const T* sA = st + ((size_t)bA * HW + xlo) * 3;
    const int n3 = ncols * 3, per3 = vec_st ? n3 / C : n3, step = vec_st ? C : 1;
    for (int q = tid; q < nrows * per3; q += nt) {
      const int n = q / per3, cc = (q - n * per3) * step;
      int db, hh;
      const int tr = row_of(n, db, hh);
      if (tr < 0) continue;
      T* d = srows + tr * SR + col0 * 3 + cc;
      const T* sp = sA + ((size_t)db * H + hh) * W * 3 + cc;
      if (vec_st) cp_async16(d, sp);
      else *d = *sp;
    }
  }
  cp_async_commit();
  stage(0, 0);
  if (F > 1) stage(1, 1);
  cp_async_commit();
  cp_async_wait<1>();  // the static's rows have landed
  __syncthreads();

  // the static part: the static's three 2-D stencils per output channel
  // with the kt=0, 1 and 2 weights, once per pixel. Output frame t's
  // static term is base = u0 + u1 + u2 + bias, less u0 at t=0 (no frame
  // t-1) and less u2 at t=F-1 (no frame t+1). base and u2 wait in the
  // thread's record in shared memory.
  float acc[3][3][V];  // output frame t sums in acc[t % 3]
  float base[3][V], u2[3][V];
  if (active) {
    float u0[3][V] = {}, u1[3][V] = {};
#pragma unroll
    for (int co = 0; co < 3; ++co)
#pragma unroll
      for (int i = 0; i < V; ++i) u2[co][i] = 0.f;
    // the window's top row at column -1
    const T* sw0 = srows + (e0 / RS) * SR + (C + V * c - 1) * 3;
#pragma unroll 1
    for (int ci = 0; ci < 3; ++ci) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        float v[V + 2];
#pragma unroll
        for (int j = 0; j < V + 2; ++j) v[j] = to_f<T>(sw0[kh * SR + 3 * j + ci]);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int co = 0; co < 3; ++co)
#pragma unroll
            for (int i = 0; i < V; ++i) {
              u0[co][i] += fw(widx(0, kh, kw, ci, co)) * v[i + kw];
              u1[co][i] += fw(widx(1, kh, kw, ci, co)) * v[i + kw];
              u2[co][i] += fw(widx(2, kh, kw, ci, co)) * v[i + kw];
            }
      }
    }
#pragma unroll
    for (int co = 0; co < 3; ++co)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        base[co][i] = u0[co][i] + u1[co][i] + u2[co][i] + fw(kNW + co);
        acc[0][co][i] = u1[co][i] + u2[co][i] + fw(kNW + co);
        acc[1][co][i] = acc[2][co][i] = 0.f;
      }
  }
  __syncthreads();  // the static rows are read: their space holds the records now
  float* rec = reinterpret_cast<float*>(smem + L.stat) + tid * kRec;
  if (active)
#pragma unroll
    for (int k4 = 0; k4 < 3 * V / 4; ++k4) {
      const int co = 4 * k4 / V, i = 4 * k4 % V;
      *reinterpret_cast<float4*>(rec + 4 * k4) =
          make_float4(base[co][i], base[co][i + 1], base[co][i + 2], base[co][i + 3]);
      *reinterpret_cast<float4*>(rec + 3 * V + 4 * k4) =
          make_float4(u2[co][i], u2[co][i + 1], u2[co][i + 2], u2[co][i + 3]);
    }
  // the record's base (part 0) or u2 (part 1)
  auto read_rec = [&](int part, float (&x)[3][V]) {
#pragma unroll
    for (int k4 = 0; k4 < 3 * V / 4; ++k4) {
      const float4 q = *reinterpret_cast<const float4*>(rec + part * 3 * V + 4 * k4);
      const int co = 4 * k4 / V, i = 4 * k4 % V;
      x[co][i] = q.x; x[co][i + 1] = q.y; x[co][i + 2] = q.z; x[co][i + 3] = q.w;
    }
  };
  if (F > 2) stage(2, 2);
  cp_async_commit();

  T* yp = y + ((size_t)b * 3 * F * H + h) * W + cx0 + V * c;
  const size_t plane = (size_t)F * HW;
  const bool owner = active && V * c < CW;
  // output frame t's V pixels of the three planes
  auto store = [&](int t, const float (&a)[3][V]) {
    if (!owner) return;
    T* p = yp + (size_t)t * HW;
    if (vec_out) {
#pragma unroll
      for (int co = 0; co < 3; ++co) store_px(p + co * plane, a[co]);
    } else {
#pragma unroll
      for (int co = 0; co < 3; ++co)
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (V * c + i < CW) p[co * plane + i] = from_f<T>(a[co][i]);
    }
  };

  // the dynamic part: frame t (t % 3 == P, ring slot P) is the kt=0 tap of
  // output t+1, the kt=1 tap of output t and the kt=2 tap of output t-1,
  // which is then complete. At t=0 the kt=2 sums and at t=F-1 the kt=0
  // sums go to outputs that do not exist and are never stored.
  auto frame = [&](int t, auto phase) {
    constexpr int P = decltype(phase)::value;
    cp_async_wait<1>();
    __syncthreads();  // frame t has landed; every thread is done with frame t-1
    if (t >= 1) {  // frame t+2 into frame t-1's slot (frames 0-2 are in)
      if (t + 2 < F) stage(t + 2, (P + 2) % 3);
      cp_async_commit();
    }
    if (!active) return;
    float(&nx)[3][V] = acc[(P + 1) % 3];
    float(&cu)[3][V] = acc[P];
    float(&pv)[3][V] = acc[(P + 2) % 3];
    read_rec(0, nx);
    const T* win = ring + P * PS + e0;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[V + 2];
      load_win(win + kh * RS, v);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int co = 0; co < 3; ++co)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            nx[co][i] += fw(widx(0, kh, kw, 3, co)) * v[i + kw];
            cu[co][i] += fw(widx(1, kh, kw, 3, co)) * v[i + kw];
            pv[co][i] += fw(widx(2, kh, kw, 3, co)) * v[i + kw];
          }
    }
    if (t >= 1) store(t - 1, pv);
  };
  for (int t = 0; t < F; t += 3) {
    frame(t, Phase<0>());
    if (t + 1 < F) frame(t + 1, Phase<1>());
    if (t + 2 < F) frame(t + 2, Phase<2>());
  }

  // output F-1, less its missing kt=2 static tap
  auto last = [&](float (&a)[3][V]) {
    float x[3][V];
    read_rec(1, x);
#pragma unroll
    for (int co = 0; co < 3; ++co)
#pragma unroll
      for (int i = 0; i < V; ++i) a[co][i] -= x[co][i];
    store(F - 1, a);
  };
  if (active) {
    const int s = (F - 1) % 3;
    if (s == 0) last(acc[0]);
    else if (s == 1) last(acc[1]);
    else last(acc[2]);
  }
}

template <typename T>
int launch_fwd(const void* st, const void* dy, const float* wb, void* y, int B,
               int F, int H, int W, cudaStream_t stream) {
  int rc = (int)cudaMemcpyToSymbolAsync(c_fwd_w, wb, kNWB * sizeof(float), 0,
                                        cudaMemcpyDeviceToDevice, stream);
  if (rc != 0) return rc;
  using Layout = FwdSmem<T>;
  const Layout L(H, W);
  const int vec_st = W % Layout::C == 0 && reinterpret_cast<uintptr_t>(st) % 16 == 0;
  const bool vec_in = W % Layout::C == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  auto kern = vec_in ? hal_fwd_kernel<T, true> : hal_fwd_kernel<T, false>;
  rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (rc != 0) return rc;
  const int vec_out = W % Layout::V == 0 &&
                      reinterpret_cast<uintptr_t>(y) % (Layout::V * sizeof(T)) == 0;
  // runs are counted in 32 bits
  const long long runs = (long long)B * H * L.TPR;
  if (runs + L.nt >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (runs + L.nt - 1) / L.nt * ((W + kFCW - 1) / kFCW);
  kern<<<(unsigned)blocks, L.nt, L.total, stream>>>(
      static_cast<const T*>(st), static_cast<const T*>(dy), static_cast<T*>(y),
      B, F, H, W, vec_st, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, int kS>
int launch_dgrad_s(const T* g, const float* wb, T* ds, T* dd, int B, int F,
                   int H, int W, cudaStream_t stream) {
  const size_t smem = DgradSmem<T>(W, kS != 0).total;
  auto kern = hal_dgrad_kernel<T, kS>;
  // the static weights' 1.3 KB count toward the 48 KB default too
  int rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  constexpr int V = 16 / sizeof(T);
  const int vec_in = W % V == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int vec_out = W % 8 == 0 && reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  const int bands = (H + kDR - 1) / kDR * ((W + kDCW - 1) / kDCW);
  kern<<<dim3(bands, B), kDThreads, smem, stream>>>(g, wb, ds, dd, F, H, W,
                                                     vec_in, vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dgrad(const void* g, const float* wb, void* ds, void* dd, int B,
                 int F, int H, int W, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  T* sp = static_cast<T*>(ds);
  T* dp = static_cast<T*>(dd);
  return ds != nullptr ? launch_dgrad_s<T, 1>(gp, wb, sp, dp, B, F, H, W, stream)
                       : launch_dgrad_s<T, 0>(gp, wb, sp, dp, B, F, H, W, stream);
}

template <typename T>
int launch_wgrad(const void* g, const void* st, const void* dy, float* part,
                 int nchunk, float* out, int B, int F, int H, int W,
                 cudaStream_t stream) {
  if (nchunk != (H + kBR - 1) / kBR) return (int)cudaErrorInvalidValue;
  const size_t smem = WgradSmem<T>(W).total;
  auto kern = wgrad_kernel(static_cast<const T*>(nullptr));
  int rc = 0;
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  const int vec = W % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(st) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  kern<<<dim3(nchunk, B), kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(st),
      static_cast<const T*>(dy), part, B, F, H, W, vec);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  hal_wgrad_finish_kernel<<<kNWB, kThreads, 0, stream>>>(part, nchunk * B, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// hal_wgrad's nchunk is the number of row bands, ceil(H / 8), and part holds
// nchunk * B rows of 327 floats (cudaErrorInvalidValue for another nchunk).
// Each returns the cudaError_t of its launches; 0 means launched.
extern "C" {

int hal_fwd(int dtype, const void* st, const void* dy, const float* wb,
            void* y, int B, int F, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_fwd<__nv_bfloat16>(st, dy, wb, y, B, F, H, W, s)
                    : launch_fwd<float>(st, dy, wb, y, B, F, H, W, s);
}

int hal_dgrad(int dtype, const void* g, const float* wb, void* ds, void* dd,
              int B, int F, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dgrad<__nv_bfloat16>(g, wb, ds, dd, B, F, H, W, s)
                    : launch_dgrad<float>(g, wb, ds, dd, B, F, H, W, s);
}

int hal_wgrad(int dtype, const void* g, const void* st, const void* dy,
              float* part, int nchunk, float* out, int B, int F, int H, int W,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_wgrad<__nv_bfloat16>(g, st, dy, part, nchunk, out, B, F, H, W, s)
             : launch_wgrad<float>(g, st, dy, part, nchunk, out, B, F, H, W, s);
}

}  // extern "C"
