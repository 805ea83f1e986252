// ConvNet3D's later-stage convolution for Hopper (sm_90a): Conv3d with
// kernel (3,7,7), stride (1,2,2), padding (1,3,3), bf16 in, fp32 sums, bf16
// out, input and output in NCDHW.
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (as a temporal im2col and a 2-D conv, models/layers.py TemporalIm2ColConv).
// On the card cuDNN's heuristic runs it in bf16 on an FFMA implicit GEMM
// without tensor cores (implicit_convolveNd_sgemm, about 27 TFLOP/s at both
// S2D-MTT shapes), and an S2D-MTT inner step makes three such convolutions
// (the forward, and two in the outer backward's double backward).
//
// What bounds it: operations. At miniUCF101's second stage (B=50, 64 -> 128
// channels, 16x28x28 in, 16x14x14 out) it is a GEMM of M = 156,800 output
// positions, N = 128 channels and K = 64*3*49 = 9,408: 377.6 GFLOP, 0.382 ms
// at the 989 TFLOP/s dense bf16 rate, against 0.05 ms for its 120 MB.
//
// Design:
//  * A block owns a tile of output positions (whole output planes, or a band
//    of rows of one plane, at most 256 positions) and 128 output channels,
//    so each input element of the tile is staged once a K-step. 8 warps: two
//    halves of the channels by four quarters of the positions; a warp holds
//    a 64-channel x 8*NT-position tile of fp32 sums in mma.sync.m16n8k16
//    accumulators (A = weights, B = input, bf16 products exact in fp32).
//  * K runs over (kt, 4-channel chunk) steps. A step stages, through a ring
//    of three buffers filled by cp.async, the weight slice (28 (ci, kh) rows
//    of 128 channels x 8 taps, 57,344 bytes, one contiguous block of the
//    prepared weight) and the tile's input rows for frame to+kt-1: 2*rows+5
//    input rows a plane, each as it lies in memory (16, 8 or 4 bytes a copy,
//    by the row's alignment; element by element otherwise), between zeros
//    (8 on the left, the halo on the right). Rows and frames outside the
//    input are written as zeros; the halo columns are zeroed once.
//  * The im2col never leaves shared memory: kw is padded to 8 taps with a
//    zero weight in front (tap j is kw = j-1), so a B fragment's pair of
//    taps (2*tig, 2*tig+1) at output column wo is one aligned 32-bit load
//    of the staged row at element 2*wo + 2*tig + 4. The seven taps come from
//    the same staged row at stride-2 offsets. A fragments come from the
//    weight slice with ldmatrix (a (ci, kh) row of 8 taps is 16 bytes).
//    The row stride in words is Wo + 8 (mod 32), so the 8 positions of a
//    fragment that straddle two output rows fall in distinct banks.
//  * A staged row's source is decoded once a block into a table in shared
//    memory, so a K-step stages a piece with one multiply-shift division and
//    one table read. Decoding every piece with runtime divisions after each
//    barrier, in all warps at once, cost 0.33 ms of 1.68 at ucf's shape.
//  * kt steps whose frame lies outside the input for every plane of the tile
//    are skipped (the first and last output frame of a clip).
//  * Epilogue: the bias (optional) is added to the fp32 sums, which are
//    rounded once to bf16 and written through shared memory, so each output
//    plane's run of positions leaves as contiguous stores (16, 8, 4 or 2
//    bytes, by alignment).
//  * No workspace, no atomics, no split-K: each output is one fixed-order
//    sum, so two launches give the same bits.
//  * Where the rest goes (H100 80GB HBM3, 700 W; ucf's shape, cuDNN 13.75
//    ms): 1.35 ms, 28% of the bound. Structure: the zero tap (8/7), the
//    positions a tile holds past a 196-position plane (224/196) and 800
//    tiles in 7 waves of 132 SMs (7/6.06) put the bound at 0.58 ms for this
//    tiling. Before the row table, cut-out variants ran 1.03 ms without the
//    stage loads and 0.64 ms without the products, against 1.68 for both:
//    the loads after each barrier barely overlap the products. mma.sync
//    from one block of 8 warps an SM (211 registers a thread at NT=7) is the
//    ceiling of this design; wgmma with TMA-fed stages is the next step.
//
// The weight arrives prepared by ops/conv3d_s2.py: (ceil(Cout/128), 3, Cin,
// 7, 128, 8) bf16, channels past Cout and tap 0 zero, so a block's K-step
// slice is contiguous. Cin must be a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 channel halves x 4 position quarters
constexpr int kCC = 4;         // input channels a K-step
constexpr int kKT = 3, kKH = 7, kTaps = 8;  // kw padded to 8 taps
constexpr int kCombos = kCC * kKH;          // (ci, kh) rows a K-step
constexpr int kCoutTile = 128;
constexpr int kStages = 3;
constexpr int kWStage = kCombos * kCoutTile * kTaps * 2;  // 57,344 bytes
constexpr int kMaxPos = 256;    // output positions a tile: 4 warps x 8 x 8
constexpr int kLeft = 8;        // zeros before w_in = 0 in a staged row
constexpr int kSmemLimit = 232448;

struct Params {
  const __nv_bfloat16* x;     // (B, Cin, T, H, W)
  const __nv_bfloat16* w;     // prepared: (Cout/128, 3, Cin, 7, 128, 8)
  const __nv_bfloat16* bias;  // (Cout) or null
  __nv_bfloat16* y;           // (B, Cout, T, Ho, Wo)
  int B, Cin, Cout, T, H, W, Ho, Wo;
  int npl;      // planes a tile
  int rb;       // output rows a tile (Ho for whole planes)
  int nr;       // staged input rows a plane: 2 * rb + 5
  int rs;       // staged row stride, elements
  int bands;    // ceil(Ho / rb)
  int vw;       // bytes a copy of an input row piece: 16, 8, 4 or 2
  int per;      // pieces a row: 2 * W / vw
  unsigned per_mul;  // q / per = umulhi(q, per_mul) >> per_shift (per > 1)
  int per_shift;
  int tab;      // byte offset of the staged-row table in shared memory
  int vo;       // elements a store of the output: 8, 4, 2 or 1
  int xstage;   // bytes of a stage's input rows (a multiple of 128)
  int ostride;  // elements a channel row of the output tile in shared memory
};

// ---- device primitives --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A * B: A 16x16 (channels x taps), B 16x8 (taps x positions) in bf16,
// D 16x8 in fp32, in the m16n8k16 fragment layout. Not volatile: it touches
// registers only, so the compiler may move it past later fragment loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the kernel -----------------------------------------------------------

// one piece of an input row, vw bytes, into shared memory (zeros if !valid)
__device__ __forceinline__ void stage_piece(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            bool valid, int vw) {
  if (valid) {
    if (vw == 16) cp_async16(dst, src);
    else if (vw == 8) cp_async8(dst, src);
    else if (vw == 4) cp_async4(dst, src);
    else *dst = *src;
  } else {
    if (vw == 16) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    else if (vw == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
    else if (vw == 4) *reinterpret_cast<uint32_t*>(dst) = 0u;
    else *reinterpret_cast<uint16_t*>(dst) = 0;
  }
}

// NT: n8 tiles of positions a warp (a tile holds at most 32 * NT positions)
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) conv3d_s2_fprop_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = warp & 1, wp = warp >> 1;    // channel half, position quarter
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  const int cb = blockIdx.y;
  const int band = blockIdx.x % p.bands;
  const int plane0 = (blockIdx.x / p.bands) * p.npl;
  const int npl = min(p.npl, p.B * p.T - plane0);
  const int ho0 = band * p.rb;
  const int run = min(p.rb, p.Ho - ho0) * p.Wo;  // positions a plane of the tile
  const int npos = npl * run;

  // the kt whose frame to+kt-1 lies inside the clip for some plane
  int kt_lo = kKT - 1, kt_hi = 0;
  for (int pl = 0; pl < npl; ++pl) {
    const int to = (plane0 + pl) % p.T;
    kt_lo = min(kt_lo, max(0, 1 - to));
    kt_hi = max(kt_hi, min(kKT - 1, p.T - to));
  }
  const int chunks = p.Cin / kCC;
  const int nsteps = (kt_hi - kt_lo + 1) * chunks;
  const int stage_bytes = kWStage + p.xstage;
  const int cs = p.npl * p.nr * p.rs;  // staged elements a channel

  // zero every stage's input rows once: the halo columns stay zero
  for (int st = 0; st < kStages; ++st) {
    uint4* z = reinterpret_cast<uint4*>(smem + st * stage_bytes + kWStage);
    for (int i = tid; i < p.xstage / 16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  // the staged rows (ci, plane, r), decoded once: the row's offset in x at
  // channel ci and frame to (-1 above or below the input, or past the
  // tile's planes) and its plane's output frame to. A K-step then stages a
  // piece with one multiply-shift division and one table read: the
  // divisions of a full decode, in every warp at once after the barrier,
  // cost more than the copies.
  int2* tab = reinterpret_cast<int2*>(smem + p.tab);
  const int rows = kCC * p.npl * p.nr;
  for (int row = tid; row < rows; row += kThreads) {
    const int r = row % p.nr, pl = (row / p.nr) % p.npl, ci = row / (p.nr * p.npl);
    const int plane = plane0 + pl, h = 2 * ho0 - 3 + r;
    int src = -1, to = 0;
    if (pl < npl) {
      to = plane % p.T;
      if (h >= 0 && h < p.H) src = (((plane / p.T * p.Cin + ci) * p.T + to) * p.H + h) * p.W;
    }
    tab[row] = make_int2(src, to);
  }
  __syncthreads();

  auto load = [&](int s, int st) {
    const int kt = kt_lo + s / chunks;
    const int ci0 = (s % chunks) * kCC;
    unsigned char* ws = smem + st * stage_bytes;
    const __nv_bfloat16* wsrc =
        p.w + ((size_t)(cb * kKT + kt) * p.Cin + ci0) * (kKH * kCoutTile * kTaps);
    for (int q = tid; q < kWStage / 16; q += kThreads) cp_async16(ws + q * 16, wsrc + q * 8);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ws + kWStage);
    const int ve = p.vw / 2;  // elements a piece
    // x at channel ci0 + ci and frame to + kt - 1, from a row's table entry
    const __nv_bfloat16* xk = p.x + ((ptrdiff_t)ci0 * p.T + kt - 1) * p.H * p.W;
    for (int q = tid; q < rows * p.per; q += kThreads) {
      const int row = p.per > 1 ? (int)(__umulhi((unsigned)q, p.per_mul) >> p.per_shift) : q;
      const int c = q - row * p.per;
      const int2 e = tab[row];
      const int t = e.y + kt - 1;
      const bool valid = e.x >= 0 && t >= 0 && t < p.T;
      stage_piece(xs + row * p.rs + kLeft + c * ve, valid ? xk + e.x + c * ve : p.x, valid,
                  p.vw);
    }
  };

  // each lane's B positions: element offsets into a staged channel
  const bool active = wp * NT * 8 < npos;
  int poff[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int pidx = (wp * NT + nt) * 8 + gid;
    int off = 0;
    if (pidx < npos) {
      const int pl = pidx / run, rem = pidx - pl * run;
      const int r = rem / p.Wo, wo = rem - r * p.Wo;
      off = (pl * p.nr + 2 * r) * p.rs + 2 * wo;
    }
    poff[nt] = 2 * (off + 2 * tig + 4);  // bytes
  }
  // each lane's ldmatrix row: matrix lane/8 is (channels +8 if odd, taps of
  // the pair's second row if >= 2)
  const uint32_t a_lane =
      (((lane >> 4) * kCoutTile + wc * 64 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 16);

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  const uint32_t sbase = smem_addr(smem);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's copies)
    __syncthreads();               // everyone's, and step s-1's buffer is free
    if (s + kStages - 1 < nsteps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    if (!active) continue;
    const uint32_t wbase = sbase + (s % kStages) * stage_bytes;
    const unsigned char* xs = smem + (s % kStages) * stage_bytes + kWStage;
    // A fragments one (ci, kh) pair ahead: ldmatrix stays in program order
    // (volatile), so the next pair's loads are issued before this pair's
    // products; the B fragments are plain shared loads the compiler
    // schedules itself
    uint32_t a[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) ldsm_x4(a[0][mt], wbase + a_lane + mt * 16 * 16);
#pragma unroll
    for (int pr = 0; pr < kCombos / 2; ++pr) {
      if (pr + 1 < kCombos / 2) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm_x4(a[(pr + 1) & 1][mt],
                  wbase + a_lane + (2 * (pr + 1) * kCoutTile + mt * 16) * 16);
      }
      const int c0 = 2 * pr, c1 = 2 * pr + 1;
      const unsigned char* x0 = xs + 2 * ((c0 / kKH) * cs + (c0 % kKH) * p.rs);
      const unsigned char* x1 = xs + 2 * ((c1 / kKH) * cs + (c1 % kKH) * p.rs);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(x0 + poff[nt]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(x1 + poff[nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[pr & 1][mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: sums (+ bias) rounded once to bf16 into a [128][ostride] tile
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  if (active) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = wc * 64 + mt * 16 + half * 8 + gid;
        const int co = cb * kCoutTile + cl;
        const float bv = (p.bias != nullptr && co < p.Cout) ? __bfloat162float(p.bias[co]) : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int pos = (wp * NT + nt) * 8 + 2 * tig;
          *reinterpret_cast<__nv_bfloat162*>(os + cl * p.ostride + pos) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half] + bv,
                                    acc[mt][nt][2 * half + 1] + bv);
        }
      }
  }
  __syncthreads();
  const int couts = min(kCoutTile, p.Cout - cb * kCoutTile);
  const int per = run / p.vo;
  const int total = couts * npl * per;
  for (int q = tid; q < total; q += kThreads) {
    int rest = q / per;
    const int c = q - rest * per;
    const int pl = rest % npl, cl = rest / npl;
    const int plane = plane0 + pl;
    const int b = plane / p.T, to = plane % p.T;
    const __nv_bfloat16* src = os + cl * p.ostride + pl * run + c * p.vo;
    __nv_bfloat16* dst =
        p.y + (((size_t)b * p.Cout + cb * kCoutTile + cl) * p.T + to) * p.Ho * p.Wo +
        (size_t)ho0 * p.Wo + c * p.vo;
    if (p.vo == 8) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (p.vo == 4) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (p.vo == 2) *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    else *dst = *src;
  }
}

template <int NT>
int launch(const Params& p, int blocks, int cblocks, int smem, cudaStream_t stream) {
  auto kern = conv3d_s2_fprop_kernel<NT>;
  int rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  kern<<<dim3(blocks, cblocks), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int largest_dividing(int n, const int* options, int count) {
  for (int i = 0; i < count; ++i)
    if (n % options[i] == 0) return options[i];
  return 1;
}

}  // namespace

// Plain C interface (loaded with ctypes). x (B, Cin, F, H, W) and y (B, Cout,
// F, Ho, Wo) bf16, contiguous, Ho = (H-1)/2 + 1, Wo = (W-1)/2 + 1; w the
// prepared weight (ops/conv3d_s2.py), bias (Cout) bf16 or null. Returns the
// cudaError_t of the launch: 0 means launched; cudaErrorInvalidValue for a
// shape the kernel does not take (Cin not a multiple of 4, an output row
// wider than 256 positions).
extern "C" int conv3d_s2_fprop(const void* x, const void* w, const void* bias, void* y,
                               int B, int Cin, int Cout, int F, int H, int W,
                               void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.B = B, p.Cin = Cin, p.Cout = Cout, p.T = F, p.H = H, p.W = W;
  p.Ho = (H - 1) / 2 + 1;
  p.Wo = (W - 1) / 2 + 1;
  if (B < 1 || Cin < kCC || Cin % kCC != 0 || Cout < 1 || F < 1 || H < 1 ||
      W < 1 || p.Wo > kMaxPos || (long long)B * Cin * F * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int planes = B * F;
  const int pos_plane = p.Ho * p.Wo;
  if (pos_plane <= kMaxPos) {
    p.rb = p.Ho;
    p.npl = kMaxPos / pos_plane;
  } else {
    p.rb = kMaxPos / p.Wo;
    p.npl = 1;
  }
  p.rs = 2 * (p.Wo + 8);
  const int vws[] = {16, 8, 4};
  p.vw = 2;
  for (int v : vws)
    if ((2 * W) % v == 0 && (2 * p.rs) % v == 0 && reinterpret_cast<uintptr_t>(x) % v == 0) {
      p.vw = v;
      break;
    }
  p.per = 2 * W / p.vw;
  p.per_mul = 0, p.per_shift = 0;
  if (p.per > 1) {  // ceil(2^(31+L) / per), L = ceil(log2(per)): exact for q < 2^31
    int l = 0;
    while ((1 << l) < p.per) ++l;
    p.per_mul = (unsigned)(((1ull << (31 + l)) + p.per - 1) / p.per);
    p.per_shift = l - 1;
  }
  // fewer planes a tile until the card holds at least two blocks an SM, and
  // until the ring fits in shared memory
  const int cblocks = (Cout + kCoutTile - 1) / kCoutTile;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.npl = std::min(p.npl, planes);
  auto blocks_of = [&](const Params& q) {
    return (long long)((planes + q.npl - 1) / q.npl) * ((q.Ho + q.rb - 1) / q.rb) * cblocks;
  };
  while (p.npl > 1 && blocks_of(p) < 2LL * sms) p.npl = (p.npl + 1) / 2;
  int smem = 0, nt = 0;
  for (;;) {
    p.nr = 2 * p.rb + 5;
    p.xstage = (kCC * p.npl * p.nr * p.rs * 2 + 127) / 128 * 128;
    nt = (p.npl * p.rb * p.Wo + 31) / 32;
    nt = nt <= 2 ? nt : nt <= 4 ? 4 : nt <= 6 ? 6 : nt;
    p.ostride = 32 * nt + 8;
    p.tab = kStages * (kWStage + p.xstage);
    smem = std::max(p.tab + kCC * p.npl * p.nr * 8, kCoutTile * p.ostride * 2);
    if (smem <= kSmemLimit) break;
    if (p.npl > 1) --p.npl;
    else if (p.rb > 1) --p.rb;
    else return (int)cudaErrorInvalidValue;
  }
  p.bands = (p.Ho + p.rb - 1) / p.rb;
  const long long blocks = blocks_of(p) / cblocks;
  if (blocks >= 0x7fffffffLL || cblocks > 65535) return (int)cudaErrorInvalidValue;
  const int vos[] = {8, 4, 2};
  p.vo = largest_dividing(pos_plane, vos, 3);
  p.vo = std::min(p.vo, largest_dividing(p.rb * p.Wo, vos, 3));
  while (p.vo > 1 && reinterpret_cast<uintptr_t>(y) % (2 * p.vo) != 0) p.vo /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch<1>(p, (int)blocks, cblocks, smem, s);
    case 2: return launch<2>(p, (int)blocks, cblocks, smem, s);
    case 4: return launch<4>(p, (int)blocks, cblocks, smem, s);
    case 6: return launch<6>(p, (int)blocks, cblocks, smem, s);
    case 7: return launch<7>(p, (int)blocks, cblocks, smem, s);
    default: return launch<8>(p, (int)blocks, cblocks, smem, s);
  }
}
