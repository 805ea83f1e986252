// Phase-max trio for Hopper (sm_90a): the 2x2 max-pool of ConvNet3D's fused
// first stage and its two linear derivatives.
//
// y (N, 4*O) holds, for each output pixel n, the four pool phases as
// contiguous O-wide channel blocks (the stride-2 GEMM's output rows).
//   phase_argmax: m[n,o] = max_k y[n, k*O+o] and idx[n,o] = the winning k
//                 (uint8). Ties go to the first maximum: the where-chain
//                 (y0 >= y1), (y2 >= y3), (m01 >= m23), torch's MaxPool2d order.
//   phase_select: out[n,o] = t[n, idx[n,o]*O + o]   (the linearisation)
//   phase_scatter: out[n, k*O+o] = (k == idx[n,o]) ? c[n,o] : 0
//                 (the exact transpose of select)
// m, select's output and scatter's input c are channel-planar with G rows
// a batch, (N/G, O, G): element (n, o) at ((n/G)*O + o)*G + n%G. ConvNet3D
// passes G = F*Ho*Wo, so m is the NCDHW tensor its second stage reads,
// with no copy.
//
// Replaces the Pallas kernels of video_distillation_tpu/ops/pallas/phase_trio.py:
//   phase_argmax_kernel  <- _argmax_kernel  (phase_trio.py:48)
//   phase_select_kernel  <- _select_kernel  (phase_trio.py:71)
//   phase_scatter_kernel <- _scatter_kernel (phase_trio.py:80)
//
// What bounds them on an H100: bytes. At the S2D-MTT inner step (N = 627,200
// rows, O = 64, bf16) each moves 441 MB (the 4O-wide tensor, the O-wide one
// and the 1-byte index), about 0.13 ms at 3.35 TB/s; there is no arithmetic
// to speak of.
//
// Design: a block owns a tile of 32 rows x 32 channels (256 threads, each
// handles 4 elements). The 4O-wide side is read or written with lanes on
// neighbouring channels of one row (coalesced). The planar O-wide side
// goes through a shared-memory transpose, so lanes walk neighbouring rows
// there and its accesses are coalesced too. The index is carried as one
// byte, so the backward passes read 1 byte per output element instead of
// recomputing masks from the 4O-wide y. Every
// output element is written by exactly one thread (scatter writes its
// zeros too), so no memset and no atomics. Comparisons are in fp32 (exact
// for bf16); values are copied, never recomputed, so outputs are exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact here: v is a bf16 value widened
}

// offset of element (n, o) of the planar O-wide tensor
__device__ __forceinline__ size_t planar_at(int n, int o, int O, int G) {
  const int b = n / G;
  return ((size_t)b * O + o) * G + (n - b * G);
}

// Write the block's tile (tile[row][channel]) to the planar O-wide output,
// lanes on neighbouring rows.
template <typename T>
__device__ __forceinline__ void store_planar(float (*tile)[kTile + 1], T* out,
                                             int n0, int o0, int N, int O,
                                             int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = n0 + lane;
  for (int ol = warp; ol < kTile; ol += kWarps) {
    const int o = o0 + ol;
    if (n < N && o < O) out[planar_at(n, o, O, G)] = from_f<T>(tile[lane][ol]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phase_argmax_kernel(const T* __restrict__ y, T* __restrict__ m,
                    uint8_t* __restrict__ idx, int N, int O, int G) {
  __shared__ float tile[kTile][kTile + 1];
  const int n0 = blockIdx.x * kTile, o0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = o0 + lane;
  for (int r = warp; r < kTile; r += kWarps) {
    const int n = n0 + r;
    if (n >= N || o >= O) continue;
    const T* row = y + (size_t)n * 4 * O + o;
    const float y0 = to_f<T>(row[0]), y1 = to_f<T>(row[O]);
    const float y2 = to_f<T>(row[2 * O]), y3 = to_f<T>(row[3 * O]);
    const bool a01 = y0 >= y1, a23 = y2 >= y3;
    const float m01 = a01 ? y0 : y1, m23 = a23 ? y2 : y3;
    const bool top = m01 >= m23;
    tile[r][lane] = top ? m01 : m23;
    idx[(size_t)n * O + o] = top ? (a01 ? 0 : 1) : (a23 ? 2 : 3);
  }
  __syncthreads();
  store_planar<T>(tile, m, n0, o0, N, O, G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phase_select_kernel(const T* __restrict__ t, const uint8_t* __restrict__ idx,
                    T* __restrict__ out, int N, int O, int G) {
  __shared__ float tile[kTile][kTile + 1];
  const int n0 = blockIdx.x * kTile, o0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = o0 + lane;
  for (int r = warp; r < kTile; r += kWarps) {
    const int n = n0 + r;
    if (n >= N || o >= O) continue;
    const int k = idx[(size_t)n * O + o];
    tile[r][lane] = to_f<T>(t[(size_t)n * 4 * O + (size_t)k * O + o]);
  }
  __syncthreads();
  store_planar<T>(tile, out, n0, o0, N, O, G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phase_scatter_kernel(const T* __restrict__ c, const uint8_t* __restrict__ idx,
                     T* __restrict__ out, int N, int O, int G) {
  __shared__ float tile[kTile][kTile + 1];
  const int n0 = blockIdx.x * kTile, o0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {  // planar read, lanes on neighbouring rows
    const int n = n0 + lane;
    for (int ol = warp; ol < kTile; ol += kWarps) {
      const int o = o0 + ol;
      if (n < N && o < O) tile[lane][ol] = to_f<T>(c[planar_at(n, o, O, G)]);
    }
  }
  __syncthreads();
  const int o = o0 + lane;
  const T zero = from_f<T>(0.f);
  for (int r = warp; r < kTile; r += kWarps) {
    const int n = n0 + r;
    if (n >= N || o >= O) continue;
    const T v = from_f<T>(tile[r][lane]);
    const int k = idx[(size_t)n * O + o];
    T* row = out + (size_t)n * 4 * O + o;
#pragma unroll
    for (int q = 0; q < 4; ++q) row[q * O] = q == k ? v : zero;
  }
}

dim3 grid_for(int N, int O) {
  return dim3((N + kTile - 1) / kTile, (O + kTile - 1) / kTile);
}

template <typename T>
int launch_argmax(const void* y, void* m, uint8_t* idx, int N, int O, int G,
                  cudaStream_t s) {
  phase_argmax_kernel<T><<<grid_for(N, O), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<T*>(m), idx, N, O, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_select(const void* t, const uint8_t* idx, void* out, int N, int O,
                  int G, cudaStream_t s) {
  phase_select_kernel<T><<<grid_for(N, O), kThreads, 0, s>>>(
      static_cast<const T*>(t), idx, static_cast<T*>(out), N, O, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const void* c, const uint8_t* idx, void* out, int N, int O,
                   int G, cudaStream_t s) {
  phase_scatter_kernel<T><<<grid_for(N, O), kThreads, 0, s>>>(
      static_cast<const T*>(c), idx, static_cast<T*>(out), N, O, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous; the wrapper checks shapes, that G > 0 divides N
// and that N fits an int. Each returns the cudaError_t of its launch; 0 means
// launched.
extern "C" {

int phase_argmax(int dtype, const void* y, void* m, uint8_t* idx, int N, int O,
                 int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_argmax<__nv_bfloat16>(y, m, idx, N, O, G, s)
                    : launch_argmax<float>(y, m, idx, N, O, G, s);
}

int phase_select(int dtype, const void* t, const uint8_t* idx, void* out, int N,
                 int O, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_select<__nv_bfloat16>(t, idx, out, N, O, G, s)
                    : launch_select<float>(t, idx, out, N, O, G, s);
}

int phase_scatter(int dtype, const void* c, const uint8_t* idx, void* out,
                  int N, int O, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_scatter<__nv_bfloat16>(c, idx, out, N, O, G, s)
                    : launch_scatter<float>(c, idx, out, N, O, G, s);
}

}  // extern "C"
