// s2d2 mover pair for Hopper (sm_90a): the fused first stage's input view
// and its exact linear transpose.
//
// pack:   x (B,F,H,W,C) -> xv (B,F,Hc,Wc,12C), Hc = H/2+4, Wc = W/2+4, with
//         xv[b,f,i,j,(2*py+px)*3+dt,c] = x[b, f+dt-1, 2i+py-4, 2j+px-4, c]
//         and 0 where that source lies outside x: a temporal im2col (frames
//         f-1, f, f+1) plus a 2x2 space-to-depth of the input padded by 4.
// unpack: g (B,F,Hc,Wc,12C) -> (B,F,H,W,C), pack's transpose. Every input
//         element sits in exactly three slots (one per dt), so
//         out[b,f,h,w,c] = sum_dt g[b, f+1-dt, h/2+2, w/2+2, (2*(h%2)+w%2)*3+dt, c]
//         over the dt whose frame f+1-dt exists.
//
// Replaces the Pallas kernels of video_distillation_tpu/ops/pallas/s2d2_move.py:
//   s2d2_pack_kernel   <- _pack_kernel   (s2d2_move.py:47)
//   s2d2_unpack_kernel <- _unpack_kernel (s2d2_move.py:73)
//
// What bounds them on an H100: pure data movement. At the S2D-MTT inner
// step (B=50, F=16, 112x112, C=3, bf16) pack reads 60 MB and writes 207 MB,
// unpack the reverse: about 0.08 ms each at 3.35 TB/s.
//
// Design: the TPU kernel loads a whole video into VMEM and shuffles slot
// planes there. Here both directions are gathers with one thread per output
// element: neighbouring threads write neighbouring addresses (coalesced
// stores), and the scattered reads of the 3-channel source pixels hit L1/L2.
// unpack sums its three slots in fp32 and rounds once; no thread writes
// another's element, so there are no atomics and the result is
// deterministic. Blocks are laid out (chunk of one frame, frame b*F+f), so
// the index arithmetic within a frame is 32-bit; offsets into the tensors
// are 64-bit. C = 3 (RGB) is specialised at compile time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

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

// kC > 0 fixes the channel count at compile time; kC == 0 reads C.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
s2d2_pack_kernel(const T* __restrict__ x, T* __restrict__ out, int F, int H,
                 int W, int C_) {
  const int C = kC > 0 ? kC : C_;
  const int Hc = H / 2 + 4, Wc = W / 2 + 4, K = 12 * C;
  const int per_frame = Hc * Wc * K;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= per_frame) return;
  const int bf = blockIdx.y;
  const int b = bf / F, f = bf - b * F;
  const int pix = e / K, k = e - pix * K;
  const int i = pix / Wc, j = pix - i * Wc;
  const int s = k / C, c = k - s * C;
  const int py = s / 6, px = (s / 3) & 1, dt = s % 3;
  const int ff = f + dt - 1, h = 2 * i + py - 4, w = 2 * j + px - 4;
  T v = from_f<T>(0.f);
  if (ff >= 0 && ff < F && h >= 0 && h < H && w >= 0 && w < W)
    v = x[(((size_t)(b * F + ff) * H + h) * W + w) * C + c];
  out[(size_t)bf * per_frame + e] = v;
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
s2d2_unpack_kernel(const T* __restrict__ g, T* __restrict__ out, int F, int H,
                   int W, int C_) {
  const int C = kC > 0 ? kC : C_;
  const int Hc = H / 2 + 4, Wc = W / 2 + 4, K = 12 * C;
  const int per_frame = H * W * C;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= per_frame) return;
  const int bf = blockIdx.y;
  const int b = bf / F, f = bf - b * F;
  const int pix = e / C, c = e - pix * C;
  const int h = pix / W, w = pix - h * W;
  const int i = h / 2 + 2, j = w / 2 + 2;
  const int slot0 = ((h & 1) * 2 + (w & 1)) * 3;
  float acc = 0.f;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    const int fo = f + 1 - dt;  // the output frame whose slot dt read frame f
    if (fo < 0 || fo >= F) continue;
    acc += to_f<T>(g[(((size_t)(b * F + fo) * Hc + i) * Wc + j) * K +
                     (slot0 + dt) * C + c]);
  }
  out[(size_t)bf * per_frame + e] = from_f<T>(acc);
}

template <typename T>
int launch_pack(const void* x, void* out, int B, int F, int H, int W, int C,
                cudaStream_t stream) {
  const int per_frame = (H / 2 + 4) * (W / 2 + 4) * 12 * C;
  const dim3 grid((per_frame + kThreads - 1) / kThreads, B * F);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (C == 3)
    s2d2_pack_kernel<T, 3><<<grid, kThreads, 0, stream>>>(xp, op, F, H, W, C);
  else
    s2d2_pack_kernel<T, 0><<<grid, kThreads, 0, stream>>>(xp, op, F, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unpack(const void* g, void* out, int B, int F, int H, int W, int C,
                  cudaStream_t stream) {
  const int per_frame = H * W * C;
  const dim3 grid((per_frame + kThreads - 1) / kThreads, B * F);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  if (C == 3)
    s2d2_unpack_kernel<T, 3><<<grid, kThreads, 0, stream>>>(gp, op, F, H, W, C);
  else
    s2d2_unpack_kernel<T, 0><<<grid, kThreads, 0, stream>>>(gp, op, F, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous; the wrapper checks shapes, that H and W are even,
// that B*F fits the grid's y dimension and that one frame's elements fit an
// int. Each returns the cudaError_t of its launch; 0 means launched.
extern "C" {

int s2d2_pack(int dtype, const void* x, void* out, int B, int F, int H, int W,
              int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_pack<__nv_bfloat16>(x, out, B, F, H, W, C, s)
                    : launch_pack<float>(x, out, B, F, H, W, C, s);
}

int s2d2_unpack(int dtype, const void* g, void* out, int B, int F, int H,
                int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_unpack<__nv_bfloat16>(g, out, B, F, H, W, C, s)
                    : launch_unpack<float>(g, out, B, F, H, W, C, s);
}

}  // extern "C"
