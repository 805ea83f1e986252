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
// What bounds it on an H100, at the evaluation shape (B=50, F=16, 112x112):
// it must move 168 MB (static 7.5 MB, dynamic 40 MB, y 120 MB), 0.050 ms at
// 3.35 TB/s, and do ~2.0 GFLOP of fp32 FMA in the temporally collapsed form
// below, 0.029 ms at 67 TFLOP/s. So it is bound by bytes: each input is read
// once from device memory and y is written once, all coalesced.
//
// Design, against that bound:
//  * One thread per output pixel (b, h, w), looping over the F frames.
//    Neighbouring threads hold neighbouring w, so loads and stores coalesce
//    and the 3x3 halo re-reads hit L1.
//  * The static channels are constant in time: for each output channel their
//    27 taps collapse to one 2-D 3x3x3 sum per temporal tap kt, computed once
//    per pixel. Frame t adds the kt=0 sum if t > 0, the kt=1 sum always, and
//    the kt=2 sum if t < F-1 (zero padding in time).
//  * The dynamic channel is a sliding window of three frames' 3x3
//    neighbourhoods (27 registers): frame t's output is the direct 27-tap sum
//    over frames t-1, t, t+1, and the window moves on by one frame per step,
//    so each dynamic value is loaded from its own frame once per thread.
//  * Weights and bias sit in shared memory (broadcast reads).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNW = 324;   // kernel taps: 3*3*3*4*3
constexpr int kNWB = 327;  // + 3 biases
constexpr int kThreads = 256;

__device__ __forceinline__ int widx(int kt, int kh, int kw, int ci, int co) {
  return (((kt * 3 + kh) * 3 + kw) * 4 + ci) * 3 + co;
}

// the 3x3 neighbourhood of (h, x) in one H x W plane, zero outside it
__device__ __forceinline__ void load3x3(const float* __restrict__ plane,
                                        int h, int x, int H, int W,
                                        float v[9]) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int hh = h + kh - 1;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ww = x + kw - 1;
      v[kh * 3 + kw] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                           ? plane[hh * W + ww] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hal_fused_kernel(const float* __restrict__ st, const float* __restrict__ dy,
                 const float* __restrict__ wb, float* __restrict__ y,
                 int F, int H, int W) {
  __shared__ float sw[kNWB];
  for (int i = threadIdx.x; i < kNWB; i += blockDim.x) sw[i] = wb[i];
  __syncthreads();
  const int HW = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t b = blockIdx.y;
  const int h = p / W, x = p - h * W;

  // static: s_tap[kt][co] = sum over (kh, kw, ci) of w * static
  float s_tap[3][3];
#pragma unroll
  for (int kt = 0; kt < 3; ++kt)
#pragma unroll
    for (int co = 0; co < 3; ++co) s_tap[kt][co] = 0.f;
  const float* sb = st + b * (size_t)HW * 3;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int hh = h + kh - 1;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ww = x + kw - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      const float* sp = sb + ((size_t)hh * W + ww) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const float v = sp[ci];
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
#pragma unroll
          for (int co = 0; co < 3; ++co)
            s_tap[kt][co] += sw[widx(kt, kh, kw, ci, co)] * v;
      }
    }
  }

  // dynamic: win[kt] holds frame t+kt-1's 3x3 neighbourhood (zero outside
  // [0, F))
  const size_t plane = (size_t)F * HW;
  const float* db = dy + b * plane;
  float* yb = y + b * 3 * plane;
  float win[3][9];
#pragma unroll
  for (int k = 0; k < 9; ++k) win[0][k] = 0.f;
  load3x3(db, h, x, H, W, win[1]);
  if (F > 1) {
    load3x3(db + HW, h, x, H, W, win[2]);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) win[2][k] = 0.f;
  }
  for (int t = 0; t < F; ++t) {
#pragma unroll
    for (int co = 0; co < 3; ++co) {
      float acc = sw[kNW + co] + s_tap[1][co];
      if (t > 0) acc += s_tap[0][co];
      if (t + 1 < F) acc += s_tap[2][co];
#pragma unroll
      for (int kt = 0; kt < 3; ++kt)
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc += sw[widx(kt, k / 3, k % 3, 3, co)] * win[kt][k];
      yb[co * plane + (size_t)t * HW + p] = acc;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      win[0][k] = win[1][k];
      win[1][k] = win[2][k];
    }
    if (t + 2 < F) {
      load3x3(db + (size_t)(t + 2) * HW, h, x, H, W, win[2]);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) win[2][k] = 0.f;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int hal_fused(const void* st, const void* dy, const void* wb,
                         void* y, int B, int F, int H, int W, void* stream) {
  const int HW = H * W;
  const dim3 grid((HW + kThreads - 1) / kThreads, B);
  hal_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st, (const float*)dy, (const float*)wb, (float*)y, F, H,
      W);
  return (int)cudaGetLastError();
}
