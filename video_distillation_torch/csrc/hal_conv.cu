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
// What bounds them on an H100: all three move about 0.8 GB and do about
// 16-20 GFLOP of fp32 FMA at the S2D-MTT shapes (B=500, F=16, 112x112,
// bf16), so the memory time (~0.25 ms at 3.35 TB/s) and the CUDA-core FMA
// time (~0.25-0.29 ms at 67 TFLOP/s) are about equal. With 3 output and
// 4 input channels there is nothing for the tensor cores to do.
//
// Design, against those bounds:
//  * One thread per output pixel (b, h, w), looping over frames. Neighbouring
//    threads hold neighbouring w, so every global load and store is
//    coalesced and the 3x3 halo re-reads hit L1.
//  * The static channels are constant in time, so their temporal taps
//    collapse to three 2-D stencils (all taps, the kt=0 tap, the kt=2 tap),
//    computed once per pixel and reused for all F frames: ~19 GFLOP instead
//    of the naive conv's 65.
//  * The dynamic channel streams through time: each frame's 3x3
//    neighbourhood is read once and scattered into the three output frames
//    it feeds, so a thread keeps 3 partial sums per channel, not a 27-value
//    window.
//  * Weights sit in shared memory (one broadcast read per FMA operand).
//  * wgrad has no sequential grid to accumulate over, unlike the TPU: each
//    block reduces its pixels' 327 partial sums in registers and warp
//    shuffles into one row of a partial-sum buffer, and a second kernel sums
//    the rows in a fixed order (deterministic, no atomics).
// Inputs may be fp32 or bf16; every sum is taken in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

__device__ __forceinline__ void load_weights(const float* __restrict__ wb, float* sw) {
  for (int i = threadIdx.x; i < kNWB; i += blockDim.x) sw[i] = wb[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward: y[b, co, t, h, w]
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
hal_fwd_kernel(const T* __restrict__ st, const T* __restrict__ dy,
               const float* __restrict__ wb, T* __restrict__ y,
               int F, int H, int W) {
  __shared__ float sw[kNWB];
  load_weights(wb, sw);
  const int HW = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t b = blockIdx.y;
  const int h = p / W, x = p - h * W;

  // static part: three collapsed 2-D stencils per output channel
  float uf[3] = {0.f, 0.f, 0.f}, u0[3] = {0.f, 0.f, 0.f}, u2[3] = {0.f, 0.f, 0.f};
  const T* sb = st + b * HW * 3;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int hh = h + kh - 1;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int ww = x + kw - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      const T* sp = sb + ((size_t)hh * W + ww) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const float v = to_f<T>(sp[ci]);
#pragma unroll
        for (int co = 0; co < 3; ++co) {
          const float w0 = sw[widx(0, kh, kw, ci, co)];
          const float w1 = sw[widx(1, kh, kw, ci, co)];
          const float w2 = sw[widx(2, kh, kw, ci, co)];
          uf[co] += (w0 + w1 + w2) * v;
          u0[co] += w0 * v;
          u2[co] += w2 * v;
        }
      }
    }
  }
  // frame t's static term: u_full + bias, minus the kt=0 tap at t=0 (no
  // frame t-1) and the kt=2 tap at t=F-1 (no frame t+1)
  float base_mid[3], base_first[3], base_last[3], base_one[3];
#pragma unroll
  for (int co = 0; co < 3; ++co) {
    base_mid[co] = uf[co] + sw[kNW + co];
    base_first[co] = base_mid[co] - u0[co];
    base_last[co] = base_mid[co] - u2[co];
    base_one[co] = base_first[co] - u2[co];
  }

  // dynamic part: frame t's neighbourhood feeds outputs t+1 (kt=0),
  // t (kt=1) and t-1 (kt=2); after frame t, output t-1 is complete
  const T* db = dy + b * (size_t)F * HW;
  const size_t plane = (size_t)F * HW;
  T* yb = y + b * 3 * plane;
  float a_prev[3] = {0.f, 0.f, 0.f}, a_cur[3];
#pragma unroll
  for (int co = 0; co < 3; ++co)
    a_cur[co] = F == 1 ? base_one[co] : base_first[co];
  for (int t = 0; t < F; ++t) {
    float a_next[3];
#pragma unroll
    for (int co = 0; co < 3; ++co)
      a_next[co] = t + 1 >= F ? 0.f : (t + 2 == F ? base_last[co] : base_mid[co]);
    const T* df = db + (size_t)t * HW;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h + kh - 1;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = x + kw - 1;
        if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
        const float v = to_f<T>(df[hh * W + ww]);
#pragma unroll
        for (int co = 0; co < 3; ++co) {
          a_next[co] += sw[widx(0, kh, kw, 3, co)] * v;
          a_cur[co] += sw[widx(1, kh, kw, 3, co)] * v;
          a_prev[co] += sw[widx(2, kh, kw, 3, co)] * v;
        }
      }
    }
    if (t >= 1) {
#pragma unroll
      for (int co = 0; co < 3; ++co)
        yb[co * plane + (size_t)(t - 1) * HW + p] = from_f<T>(a_prev[co]);
    }
#pragma unroll
    for (int co = 0; co < 3; ++co) {
      a_prev[co] = a_cur[co];
      a_cur[co] = a_next[co];
    }
  }
#pragma unroll
  for (int co = 0; co < 3; ++co)
    yb[co * plane + (size_t)(F - 1) * HW + p] = from_f<T>(a_prev[co]);
}

// ---------------------------------------------------------------------------
// dgrad: ds[b, h, w, ci] (optional) and dd[b, t, h, w] (optional) from g
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
hal_dgrad_kernel(const T* __restrict__ g, const float* __restrict__ wb,
                 T* __restrict__ ds, T* __restrict__ dd, int F, int H, int W) {
  __shared__ float sw[kNWB];
  load_weights(wb, sw);
  const int HW = H * W;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t b = blockIdx.y;
  const int h = p / W, x = p - h * W;
  const size_t plane = (size_t)F * HW;
  const T* gb = g + b * 3 * plane;

  if (dd != nullptr) {
    // g frame t at (h+1-kh, w+1-kw) feeds dd frames t-1 (kt=0), t (kt=1)
    // and t+1 (kt=2); after frame t, dd frame t-1 is complete
    T* ddb = dd + b * plane;
    float a_prev = 0.f, a_cur = 0.f;
    for (int t = 0; t < F; ++t) {
      float a_next = 0.f;
      const T* gf = gb + (size_t)t * HW;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = h + 1 - kh;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = x + 1 - kw;
          if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
#pragma unroll
          for (int co = 0; co < 3; ++co) {
            const float v = to_f<T>(gf[co * plane + hh * W + ww]);
            a_prev += sw[widx(0, kh, kw, 3, co)] * v;
            a_cur += sw[widx(1, kh, kw, 3, co)] * v;
            a_next += sw[widx(2, kh, kw, 3, co)] * v;
          }
        }
      }
      if (t >= 1) ddb[(size_t)(t - 1) * HW + p] = from_f<T>(a_prev);
      a_prev = a_cur;
      a_cur = a_next;
    }
    ddb[(size_t)(F - 1) * HW + p] = from_f<T>(a_prev);
  }

  if (ds != nullptr) {
    // the static input at (h, w) reaches every frame: per neighbour, the
    // temporal sums of g over the frames each kt tap is valid for
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h + 1 - kh;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = x + 1 - kw;
        if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
        const size_t q = (size_t)hh * W + ww;
#pragma unroll
        for (int co = 0; co < 3; ++co) {
          const T* gq = gb + co * plane + q;
          float s_all = 0.f;
          for (int t = 0; t < F; ++t) s_all += to_f<T>(gq[(size_t)t * HW]);
          const float t0 = s_all - to_f<T>(gq[0]);                      // kt=0: t >= 1
          const float t2 = s_all - to_f<T>(gq[(size_t)(F - 1) * HW]);   // kt=2: t <= F-2
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            acc[ci] += sw[widx(0, kh, kw, ci, co)] * t0 +
                       sw[widx(1, kh, kw, ci, co)] * s_all +
                       sw[widx(2, kh, kw, ci, co)] * t2;
        }
      }
    }
    T* dsp = ds + (b * HW + p) * 3;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) dsp[ci] = from_f<T>(acc[ci]);
  }
}

// ---------------------------------------------------------------------------
// wgrad, pass 1: one row of 327 partial sums per (pixel chunk, sample).
// Columns: [0, 81) dynamic taps (kt,kh,kw) x co; then for each co a block
// of 82 = A (27: kh,kw,ci) | Bf (27) | Bl (27) | bias, where
// A = sum_t g * s, Bf = g[t=0] * s, Bl = g[t=F-1] * s. blockIdx.z picks
// the group: 0 = dynamic, 1..3 = static for co = z-1.
// ---------------------------------------------------------------------------
constexpr int kCols = 327;
constexpr int kGroupCols = 82;

template <int N>
__device__ __forceinline__ void block_reduce_store(float (&v)[N], float* red,
                                                   float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * N + j] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nwarps; ++k) s += red[k * N + j];
    out[j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hal_wgrad_partial_kernel(const T* __restrict__ g, const T* __restrict__ st,
                         const T* __restrict__ dy, float* __restrict__ part,
                         int B, int F, int H, int W) {
  __shared__ float red[(kThreads / 32) * kGroupCols];
  const int HW = H * W;
  const int nchunk = gridDim.x, chunk = blockIdx.x;
  const size_t b = blockIdx.y;
  const int group = blockIdx.z;
  const int lo = (int)((long long)chunk * HW / nchunk);
  const int hi = (int)((long long)(chunk + 1) * HW / nchunk);
  const size_t plane = (size_t)F * HW;
  const T* gb = g + b * 3 * plane;
  float* row = part + ((size_t)chunk * B + b) * kCols;

  if (group == 0) {
    // dynamic taps: sum over (t, pixel) of g[co, t] * d[t+kt-1, nbr]
    float acc[81];
#pragma unroll
    for (int j = 0; j < 81; ++j) acc[j] = 0.f;
    const T* db = dy + b * plane;
    for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      const int h = p / W, x = p - h * W;
      float win[3][9];  // neighbourhoods of frames t-1, t, t+1
#pragma unroll
      for (int k = 0; k < 9; ++k) win[0][k] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int hh = h + kh - 1, ww = x + kw - 1;
          win[1][kh * 3 + kw] = (hh < 0 || hh >= H || ww < 0 || ww >= W)
                                    ? 0.f : to_f<T>(db[hh * W + ww]);
        }
      for (int t = 0; t < F; ++t) {
        const T* dn = db + (size_t)(t + 1) * HW;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int hh = h + kh - 1, ww = x + kw - 1;
            win[2][kh * 3 + kw] =
                (t + 1 >= F || hh < 0 || hh >= H || ww < 0 || ww >= W)
                    ? 0.f : to_f<T>(dn[hh * W + ww]);
          }
        float gv[3];
#pragma unroll
        for (int co = 0; co < 3; ++co) gv[co] = to_f<T>(gb[co * plane + (size_t)t * HW + p]);
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
#pragma unroll
          for (int k = 0; k < 9; ++k)
#pragma unroll
            for (int co = 0; co < 3; ++co)
              acc[(kt * 9 + k) * 3 + co] += gv[co] * win[kt][k];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          win[0][k] = win[1][k];
          win[1][k] = win[2][k];
        }
      }
    }
    block_reduce_store<81>(acc, red, row);
  } else {
    const int co = group - 1;
    float acc[kGroupCols];
#pragma unroll
    for (int j = 0; j < kGroupCols; ++j) acc[j] = 0.f;
    const T* sb = st + b * HW * 3;
    const T* gc = gb + co * plane;
    for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
      const int h = p / W, x = p - h * W;
      float s_all = 0.f;
      for (int t = 0; t < F; ++t) s_all += to_f<T>(gc[(size_t)t * HW + p]);
      const float g_first = to_f<T>(gc[p]);
      const float g_last = to_f<T>(gc[(size_t)(F - 1) * HW + p]);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int hh = h + kh - 1, ww = x + kw - 1;
          if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
          const T* sp = sb + ((size_t)hh * W + ww) * 3;
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float v = to_f<T>(sp[ci]);
            const int n = (kh * 3 + kw) * 3 + ci;
            acc[n] += s_all * v;
            acc[27 + n] += g_first * v;
            acc[54 + n] += g_last * v;
          }
        }
      acc[81] += s_all;
    }
    block_reduce_store<kGroupCols>(acc, red, row + 81 + co * kGroupCols);
  }
}

// wgrad, pass 2: block j sums column(s) over all rows in a fixed order and
// writes final value j: dk in (kt,kh,kw,ci,co) order for j < 324, then db.
__global__ void __launch_bounds__(kThreads)
hal_wgrad_finish_kernel(const float* __restrict__ part, int rows,
                        float* __restrict__ out) {
  __shared__ float red[kThreads / 32];
  const int j = blockIdx.x;
  int c1, c2 = -1;
  if (j < kNW) {
    const int co = j % 3, ci = (j / 3) % 4, tap = j / 12;
    const int kt = tap / 9, k = tap % 9;
    if (ci == 3) {
      c1 = tap * 3 + co;
    } else {
      // static: kt=1 sees every frame (A); kt=0 misses frame 0 (A - Bf);
      // kt=2 misses frame F-1 (A - Bl)
      c1 = 81 + co * kGroupCols + k * 3 + ci;
      if (kt == 0) c2 = c1 + 27;
      if (kt == 2) c2 = c1 + 54;
    }
  } else {
    c1 = 81 + (j - kNW) * kGroupCols + 81;
  }
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s += part[(size_t)r * kCols + c1];
    if (c2 >= 0) s -= part[(size_t)r * kCols + c2];
  }
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

template <typename T>
int launch_fwd(const void* st, const void* dy, const float* wb, void* y, int B,
               int F, int H, int W, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  hal_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(st), static_cast<const T*>(dy), wb,
      static_cast<T*>(y), F, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dgrad(const void* g, const float* wb, void* ds, void* dd, int B,
                 int F, int H, int W, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  hal_dgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), wb, static_cast<T*>(ds), static_cast<T*>(dd),
      F, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* g, const void* st, const void* dy, float* part,
                 int nchunk, float* out, int B, int F, int H, int W,
                 cudaStream_t stream) {
  const dim3 grid(nchunk, B, 4);
  hal_wgrad_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(st),
      static_cast<const T*>(dy), part, B, F, H, W);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  hal_wgrad_finish_kernel<<<kNWB, kThreads, 0, stream>>>(part, nchunk * B, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
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
