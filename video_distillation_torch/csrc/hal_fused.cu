// Fused no-grad hallucinator composition for Hopper (sm_90a).
//
// y = Conv3d([broadcast_F(static) | dynamic], weight, pad 1) + bias, in fp32:
// static (B,H,W,3), dynamic (B,F,H,W,1), y (B,3,F,H,W) channel-planar.
// Weights arrive as one fp32 vector of 327 values: the kernel flattened in
// (kt, kh, kw, ci, co) order (the JAX package's DHWIO layout, ci 0-2 the
// static RGB channels, ci 3 the dynamic one), then the 3 biases.
//
// Replaces the Pallas kernel video_distillation_tpu/ops/pallas/
// hallucinator_kernel.py:33 (_kernel, called by hallucinate_fused :91): the
// forward-only composition that the evaluation path runs on frozen
// memories. There is no backward.
//
// What bounds it on an H100 (80GB HBM3, 700 W), at the evaluation shape
// (B=50, F=16, 112x112): it must move 168 MB (static 7.5 MB, dynamic 40 MB,
// y 120 MB), 0.050 ms at the data sheet's 3.35 TB/s, and do ~2.0 GFLOP of
// fp32 FMA in the temporally collapsed form, 0.029 ms at 67 TFLOP/s. So
// bytes bound it, and 120 MB of them are stores. On that card
// (scripts/ablate_hal_dgrad.py --kernel hal_fused) a plain fill of y takes
// 0.038 ms; this kernel 0.079 ms, 0.073 with every FFMA cut (its copies and
// stores alone) and 0.049 with its stores alone.
//
// Design, against that bound:
//  * A thread owns a run of 4 neighbouring pixels of a row; a block owns 256
//    consecutive runs counted row-major over all samples' rows (8 full
//    warps at a width of 112; 3 blocks an SM at 80 registers). An output
//    frame leaves as one 16-byte store per channel plane.
//  * Weights: copied to __constant__ memory on the launch's stream before
//    each launch; each FFMA takes its weight from the constant bank, with
//    no load (a shared-memory load beside each FFMA, the previous design's
//    weight path, costs about a quarter more time).
//  * The dynamic frames stream through a ring of three shared tiles, two
//    frames ahead, with 16-byte cp.async copies from a list built once a
//    block, behind one barrier a frame. Zero rows and columns (halos, and
//    between two samples' rows) replace bounds checks in the tap loop.
//  * The static is constant in time: output frame t's static term is
//    base = u0 + u1 + u2 + bias (u_kt its 2-D stencil with the kt weights),
//    less u0 at t=0 and less u2 at t=F-1. Only base is taken before the
//    frames stream, as one stencil with the kt-summed weights (a kh row of
//    them in registers at a time); u0 and u2 come off outputs 0 and F-1
//    inside the frame loop, as those leave, from the static rows kept in
//    shared memory for the whole block.
//  * One loop body for every frame: the three running sums move down by one
//    a frame (24 register moves), a third of the code of a loop unrolled by
//    three.
//  * Where the rest goes (the same script): without the static part it
//    takes 0.071 ms, without u0 and u2 alone 0.075. Those run in step
//    across each wave of blocks (B=50 makes 1.55 waves of 3 blocks an SM),
//    so the copies and stores do not hide them; taking them at a frame that
//    differs from block to block needs more than the 80 registers that 3
//    blocks an SM leave, and spills.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNW = 324;          // kernel taps: 3*3*3*4*3
constexpr int kNWB = 327;         // + 3 biases
constexpr int kV = 4;             // pixels a run: one float4
constexpr int kC = 4;             // floats a 16-byte copy
constexpr int kCW = 128;          // most columns a column band
constexpr int kThreads = 256;     // most threads a block
constexpr int kBlocksPerSM = 3;   // the registers are cut for this many blocks an SM
constexpr int kAhead = 2;         // dynamic frames in flight
constexpr int kSlots = kAhead + 1;
constexpr int kWRow = 28;         // summed static weights a kh row: 27, padded to 16 bytes

// The weights and biases of the launch in flight, copied from the caller's
// buffer on the launch's stream just before it, so each FFMA takes its
// weight from the constant bank with no load. Launches on one stream are
// ordered, so back-to-back launches with other weights (the evaluation's
// n_hal > 1 path) each see their own; launches on two streams must not
// overlap.
__constant__ float c_w[kNWB];

__device__ __forceinline__ float wt(int i) { return c_w[i]; }

__host__ __device__ constexpr int widx(int kt, int kh, int kw, int ci, int co) {
  return (((kt * 3 + kh) * 3 + kw) * 4 + ci) * 3 + co;
}

template <int N> using Phase = std::integral_constant<int, N>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Work split: a thread owns a run of kV neighbouring pixels of a row, and
// a column band's runs are numbered row-major over all samples' rows; a
// tile is nt consecutive runs (8 full warps at any width), spanning at most
// rows_max image rows, which may belong to more than one sample.
//
// Shared memory, the same layout on the host and the device: the ring of
// kSlots dynamic tiles, the static's rows as they lie in memory
// (pixel-interleaved), the kt-summed static weights, and the list of a
// frame's 16-byte copies. A
// tile row holds one image row: the tile's rows in order, each sample's
// rows between a zero row above and below, so a window never reaches into
// another sample. Element kC + x of a tile row holds column cx0 + x, x in
// [-kC, TPR*kV + kC). Tile rows are 128 bytes longer than a band's pixels,
// so the window loads of a warp's lanes, consecutive runs of consecutive
// rows, fall in different banks. A static row holds the same columns, three
// floats each.
struct Layout {
  int TPR, nt, rows_max, Rt, RS, PS, SR, ncb;
  size_t stat, wsum, list, total;  // byte offsets; the ring at 0, zeros up to wsum
  __host__ __device__ Layout(int H, int W) {
    TPR = ((W < kCW ? W : kCW) + kV - 1) / kV;
    nt = 32 * TPR < kThreads ? 32 * TPR : kThreads;
    rows_max = (nt - 1) / TPR + 2;
    int samples = (rows_max - 1) / H + 2;
    samples = samples < rows_max ? samples : rows_max;
    Rt = rows_max + 2 * samples;
    RS = TPR * kV + 32;
    PS = Rt * RS;
    SR = (TPR * kV + 2 * kC) * 3;
    ncb = (W + kCW - 1) / kCW;
    stat = (size_t)kSlots * PS * 4;
    wsum = stat + (size_t)Rt * SR * 4;
    list = wsum + (size_t)3 * kWRow * 4;
    // a frame's copies: rows_max + 2 image rows of at most TPR*kV + 2kC columns
    total = list + (size_t)(rows_max + 2) * ((TPR * kV + 2 * kC) / kC) * sizeof(uint2);
  }
};

// A tile's place: column band, runs, rows g_first .. g_last counted over all
// samples, samples bA .. bZ, and the columns xlo .. xlo+ncols-1 it reads.
struct Tile {
  int cx0, CW, k0, g_first, g_last, bA, bZ, nrows, xlo, ncols, col0;
  __device__ Tile(int tile, const Layout& L, int nk, int H, int W) {
    const int cb = tile % L.ncb;
    cx0 = cb * kCW;
    CW = min(kCW, W - cx0);
    k0 = (tile / L.ncb) * L.nt;
    g_first = k0 / L.TPR;
    g_last = (min(k0 + L.nt, nk) - 1) / L.TPR;
    bA = g_first / H;
    bZ = g_last / H;
    nrows = g_last - g_first + 3;
    xlo = max(cx0 - kC, 0);
    ncols = min(cx0 + L.TPR * kV + kC, W) - xlo;
    col0 = kC + xlo - cx0;
  }
  // Image rows read are n = 0 .. nrows-1, row g_first-1+n: the output rows
  // and the rows above and below them, those of the first and the last
  // sample only. Row n's sample is bA + db, its tile row n + 2 db; -1 marks
  // a row that is not read (it stays zero).
  __device__ int row_of(int n, int B, int H, int& db, int& hh) const {
    const int gg = g_first - 1 + n;
    if (gg < 0 || gg >= B * H) return -1;
    const int bb = gg / H;
    if ((n == 0 && bb != bA) || (n == nrows - 1 && bb != bZ)) return -1;
    db = bb - bA;
    hh = gg - bb * H;
    return n + 2 * db;
  }
};

// the static's rows of tile T into srows: 16 bytes a cp.async where vec_st,
// else element by element
__device__ __forceinline__ void stage_static(const Tile& T, const Layout& L,
                                             const float* __restrict__ st,
                                             float* srows, int vec_st, int B,
                                             int H, int W, int tid) {
  const float* sA = st + ((size_t)T.bA * H * W + T.xlo) * 3;
  const int n3 = T.ncols * 3, per3 = vec_st ? n3 / kC : n3, step = vec_st ? kC : 1;
  for (int q = tid; q < T.nrows * per3; q += L.nt) {
    const int n = q / per3, cc = (q - n * per3) * step;
    int db, hh;
    const int tr = T.row_of(n, B, H, db, hh);
    if (tr < 0) continue;
    float* d = srows + tr * L.SR + T.col0 * 3 + cc;
    const float* sp = sA + ((size_t)db * H + hh) * W * 3 + cc;
    if (vec_st) cp_async16(d, sp);
    else *d = *sp;
  }
}

// a window row: columns x-1 .. x+4 around the thread's pixels x .. x+3 at p
__device__ __forceinline__ void load_win(const float* p, float (&v)[6]) {
  const float4 m = *reinterpret_cast<const float4*>(p);
  v[0] = p[-1];
  v[1] = m.x; v[2] = m.y; v[3] = m.z; v[4] = m.w;
  v[5] = p[4];
}

// 20 floats of a static row from p (16-byte aligned) on
__device__ __forceinline__ void static_row(const float* p, float (&v)[20]) {
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float4 m = *reinterpret_cast<const float4*>(p + 4 * j);
    v[4 * j] = m.x; v[4 * j + 1] = m.y; v[4 * j + 2] = m.z; v[4 * j + 3] = m.w;
  }
}

// kVec: the dynamic's rows are 16-byte multiples and start 16-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
hal_fused_kernel(const float* __restrict__ st, const float* __restrict__ dy,
                 float* __restrict__ y, int B, int F, int H, int W, int vec_st,
                 int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H, W);
  const int TPR = L.TPR, RS = L.RS, PS = L.PS, SR = L.SR, nt = L.nt;
  float* ring = reinterpret_cast<float*>(smem);
  float* srows = reinterpret_cast<float*>(smem + L.stat);
  float* ws = reinterpret_cast<float*>(smem + L.wsum);
  uint2* list = reinterpret_cast<uint2*>(smem + L.list);
  const int tid = threadIdx.x;
  const size_t HW = (size_t)H * W, plane = (size_t)F * HW;
  const int nk = B * H * TPR;
  const Tile T(blockIdx.x, L, nk, H, W);
  // this thread's run: row g (sample b, row h), run c of the band; its
  // window's top row (image row h-1) is tile row r
  const int k = T.k0 + tid;
  const bool active = k < nk;
  const int g = active ? k / TPR : T.g_first;
  const int c = k - g * TPR, b = g / H, h = g - b * H;
  const int r = g - T.g_first + 2 * (b - T.bA);
  const int e0 = r * RS + kC + kV * c;

  // zeros: what lies outside the image stays so
  for (int q = tid; q < (int)(L.wsum / 16); q += nt)
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  // the static weights summed over kt, in (kh, kw, ci, co) order
  for (int j = tid; j < 27 * 3; j += nt) {
    const int kh = j / 27, q = j - kh * 27, kw = q / 9, ci = q / 3 % 3, co = q % 3;
    ws[kh * kWRow + q] = wt(widx(0, kh, kw, ci, co)) + wt(widx(1, kh, kw, ci, co)) +
                         wt(widx(2, kh, kw, ci, co));
  }
  // the list of a frame's copies, (source offset in a frame of dyT, tile
  // offset) a 16-byte chunk (kVec) or a run of up to kC elements; ~0u
  // marks a row that is not read
  const float* dyT = dy + (size_t)T.bA * plane + T.xlo;
  const int per = (T.ncols + kC - 1) / kC, nch = T.nrows * per;
  for (int q = tid; q < nch; q += nt) {
    const int n = q / per, cc = (q - n * per) * kC;
    int db, hh;
    const int tr = T.row_of(n, B, H, db, hh);
    list[q] = tr < 0 ? make_uint2(~0u, 0u)
                     : make_uint2((uint32_t)(((size_t)db * F * H + hh) * W + cc),
                                  (uint32_t)(tr * RS + T.col0 + cc));
  }
  __syncthreads();
  // dynamic frame t into ring slot s
  auto stage = [&](int t, int s) {
    float* slot = ring + s * PS;
    const float* src = dyT + (size_t)t * HW;
    for (int q = tid; q < nch; q += nt) {
      const uint2 e = list[q];
      if (e.x == ~0u) continue;
      if constexpr (kVec) {
        cp_async16(slot + e.y, src + e.x);
      } else {
        const int cnt = min(kC, T.ncols - (q % per) * kC);
        for (int i = 0; i < cnt; ++i) slot[e.y + i] = src[e.x + i];
      }
    }
  };
  stage_static(T, L, st, srows, vec_st, B, H, W, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < F) stage(j, j);
    cp_async_commit();
  }
  cp_async_wait<kAhead>();  // the static's rows have landed
  __syncthreads();

  // the static part (see the note at the top): base before the frames
  // stream; u0 and u2 as outputs 0 and F-1 leave.
  // 20 floats of the window's top row from a 16-byte boundary on, whose
  // floats 1 .. 18 are columns -1 .. kV (three channels each)
  const float* s0 = srows + r * SR + (kC + kV * c) * 3 - 4;
  float base[3][kV];
#pragma unroll
  for (int co = 0; co < 3; ++co)
#pragma unroll
    for (int i = 0; i < kV; ++i) base[co][i] = wt(kNW + co);
  if (active) {
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
      float w[kWRow], v[20];
#pragma unroll
      for (int j = 0; j < kWRow / 4; ++j) {
        const float4 m = *reinterpret_cast<const float4*>(ws + kh * kWRow + 4 * j);
        w[4 * j] = m.x; w[4 * j + 1] = m.y; w[4 * j + 2] = m.z; w[4 * j + 3] = m.w;
      }
      static_row(s0 + kh * SR, v);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
          for (int co = 0; co < 3; ++co)
#pragma unroll
            for (int i = 0; i < kV; ++i)
              base[co][i] += w[(kw * 3 + ci) * 3 + co] * v[1 + 3 * (i + kw) + ci];
    }
  }
  // a -= u_KT at the thread's pixels
  auto sub_stencil = [&](auto kt, float (&a)[3][kV]) {
    constexpr int KT = decltype(kt)::value;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[20];
      static_row(s0 + kh * SR, v);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
          for (int co = 0; co < 3; ++co)
#pragma unroll
            for (int i = 0; i < kV; ++i)
              a[co][i] = fmaf(-wt(widx(KT, kh, kw, ci, co)), v[1 + 3 * (i + kw) + ci],
                              a[co][i]);
    }
  };
  // pv, cu, nx: the sums of output frames t-1, t and t+1
  float pv[3][kV], cu[3][kV], nx[3][kV];
#pragma unroll
  for (int co = 0; co < 3; ++co)
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      cu[co][i] = base[co][i];
      pv[co][i] = 0.f;
    }

  float* yp = y + ((size_t)b * 3 * F * H + h) * W + T.cx0 + kV * c;
  const bool owner = active && kV * c < T.CW;
  // output frame t's kV pixels of the three planes
  auto store = [&](int t, const float (&a)[3][kV]) {
    if (!owner) return;
    float* p = yp + (size_t)t * HW;
    if (vec_out) {
#pragma unroll
      for (int co = 0; co < 3; ++co)
        *reinterpret_cast<float4*>(p + co * plane) =
            make_float4(a[co][0], a[co][1], a[co][2], a[co][3]);
    } else {
#pragma unroll
      for (int co = 0; co < 3; ++co)
#pragma unroll
        for (int i = 0; i < kV; ++i)
          if (kV * c + i < T.CW) p[co * plane + i] = a[co][i];
    }
  };

  // the dynamic part: frame t is the kt=0 tap of output t+1, the kt=1 tap
  // of output t and the kt=2 tap of output t-1, which is then complete. At
  // t=0 the kt=2 sums and at t=F-1 the kt=0 sums go to outputs that do not
  // exist and are never stored. One loop body for every frame (the sums
  // move down by one a frame), so the hot loop stays small in the
  // instruction cache.
#pragma unroll 1
  for (int t = 0; t < F; ++t) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();  // frame t has landed; every thread is done with frame t-1
    if (t + kAhead < F) stage(t + kAhead, (t + kAhead) % kSlots);
    cp_async_commit();
    if (!active) continue;
#pragma unroll
    for (int co = 0; co < 3; ++co)
#pragma unroll
      for (int i = 0; i < kV; ++i) nx[co][i] = base[co][i];
    const float* win = ring + (t % kSlots) * PS + e0;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[6];
      load_win(win + kh * RS, v);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int co = 0; co < 3; ++co)
#pragma unroll
          for (int i = 0; i < kV; ++i) {
            nx[co][i] += wt(widx(0, kh, kw, 3, co)) * v[i + kw];
            cu[co][i] += wt(widx(1, kh, kw, 3, co)) * v[i + kw];
            pv[co][i] += wt(widx(2, kh, kw, 3, co)) * v[i + kw];
          }
    }
    if (t == 1) sub_stencil(Phase<0>(), pv);
    if (t >= 1) store(t - 1, pv);
#pragma unroll
    for (int co = 0; co < 3; ++co)
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        pv[co][i] = cu[co][i];
        cu[co][i] = nx[co][i];
      }
  }
  // output F-1, less its missing kt=2 static tap (and at F=1 its kt=0 one)
  if (active) {
    if (F == 1) sub_stencil(Phase<0>(), pv);
    sub_stencil(Phase<2>(), pv);
    store(F - 1, pv);
  }
}

int launch(const float* st, const float* dy, const float* wb, float* y, int B,
           int F, int H, int W, cudaStream_t stream) {
  int rc = (int)cudaMemcpyToSymbolAsync(c_w, wb, kNWB * sizeof(float), 0,
                                        cudaMemcpyDeviceToDevice, stream);
  if (rc != 0) return rc;
  const Layout L(H, W);
  const bool vec_in = W % kC == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int vec_st = W % kC == 0 && reinterpret_cast<uintptr_t>(st) % 16 == 0;
  const int vec_out = W % kV == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto kern = vec_in ? hal_fused_kernel<true> : hal_fused_kernel<false>;
  rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)L.total);
  if (rc != 0) return rc;
  // runs and tiles are counted in 32 bits
  const long long runs = (long long)B * H * L.TPR;
  const long long tiles = (runs + L.nt - 1) / L.nt * L.ncb;
  if (runs + L.nt >= 0x7fffffffLL || tiles >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)tiles, L.nt, L.total, stream>>>(st, dy, y, B, F, H, W, vec_st,
                                                  vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes): wb is the caller's device buffer
// of 327 floats. Returns the cudaError_t of the launch (0 on success).
extern "C" int hal_fused(const void* st, const void* dy, const void* wb,
                         void* y, int B, int F, int H, int W, void* stream) {
  return launch(static_cast<const float*>(st), static_cast<const float*>(dy),
                static_cast<const float*>(wb), static_cast<float*>(y), B, F, H,
                W, static_cast<cudaStream_t>(stream));
}
