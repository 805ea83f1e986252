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
// pack's design. The TPU kernel loads a whole video into VMEM and shuffles
// slot planes there. A block here covers (b, f, a band of R packed rows):
//  * It stages the 2R input rows of frames f-1, f and f+1 that the band
//    reads (each frame's rows are one contiguous span of x) into shared
//    memory with 16-byte cp.async; a frame that does not exist and rows
//    that fall in the 4-pixel pad are not loaded.
//  * The band's output rows are one contiguous span of xv. Each thread
//    assembles 16 bytes of it (8 bf16 or 4 fp32) from shared memory and
//    writes them with one vector store; neighbouring threads write
//    neighbouring chunks. One divide chain a chunk finds its first packed
//    pixel and slot; then each word is a lookup in a slot table in shared
//    memory (the slot's offset in the staged tile, or -1 for a missing
//    frame) plus the pixel's base, stepped word by word (C = 3 at compile
//    time). The pad and a missing frame's slots are written as zeros
//    without a load.
//  * It copies bits (16- or 32-bit words), so xv equals the plain version
//    exactly. Shapes whose rows are not a multiple of 16 bytes, or a band
//    that does not start on a 16-byte boundary of xv, take scalar loads and
//    a scalar head and tail inside the kernel; xv's base must be 16-byte
//    aligned (the wrapper allocates it).
// Consecutive blocks are the bands of one frame and then the next frame's,
// so the three blocks that read an input frame run close together and all
// but the first find it in L2.
//
// unpack's design. The old kernel (a thread an output element, three
// scattered 2-byte reads, each packed sector pulled into two SMs) reached
// 39% of its byte bound. A block here covers (b, a band of R packed rows,
// a run of kUFrames output frames):
//  * It streams the interiors (the pad is cropped, so packed rows 2..Hc-3
//    and columns 2..Wc-3 only) of its packed rows, frame by frame, through
//    a ring of kURing slots in shared memory with 16-byte cp.async,
//    kUAhead frames ahead; each packed row's interior is one contiguous
//    span of g. Output frame f reads packed frames f+1, f and f-1, so each
//    packed frame is read once for the three outputs that need it (once
//    more at the edges of a block's run), not three times as a block per
//    frame would. A frame that does not exist is not loaded.
//    (A block per (b, f, band) that stages three frames and relies on L2
//    for the re-reads took 0.175 ms at the slice's shape; this ring
//    0.134 ms, H100 80GB HBM3, 700 W.)
//  * The band's 2R output rows of frame f are one contiguous span of out.
//    Each thread assembles 16 bytes of it (8 bf16 or 4 fp32): one divide
//    chain a chunk finds its first element, then each element's three
//    slots sit at one offset in the three ring slots (C = 3 at compile
//    time), summed in fp32 in the order dt = 0, 1, 2 and rounded once, as
//    unpack_plain does, so the result equals it bit for bit in both
//    dtypes. No thread writes another's element: no atomics,
//    deterministic. Rows that are not a multiple of 16 bytes take scalar
//    staging, and a band that does not start on a 16-byte boundary of out
//    a scalar head and tail, inside the kernel; out's base must be 16-byte
//    aligned (the wrapper allocates it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a pack block aims at: R is the most rows whose 3 frames fit
constexpr int kPackTileBytes = 24 * 1024;
// an unpack block: a ring of kURing packed frames, each R packed rows, R
// the most whose interiors fit kUnpackSlotBytes; kUFrames output frames
// a block, streamed kUAhead packed frames ahead, kUThreads threads
constexpr int kUnpackSlotBytes = 8 * 1024;
constexpr int kUAhead = 1;
constexpr int kURing = kUAhead + 3;
constexpr int kUFrames = 8;
constexpr int kUThreads = 256;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// pack's staged input: planes dt = 0, 1, 2 of 2R rows of W*C words each,
// a plane padded by 16 bytes so that the planes start in other banks.
template <typename U>
__host__ __device__ __forceinline__ int pack_plane(int R, int WC) {
  return 2 * R * WC + 16 / (int)sizeof(U);
}

// kC > 0 fixes the channel count at compile time; kC == 0 reads C. U is
// the element's storage word (uint16_t for bf16, uint32_t for fp32).
template <typename U, int kC>
__global__ void __launch_bounds__(kThreads)
s2d2_pack_kernel(const U* __restrict__ x, U* __restrict__ out, int F, int H,
                 int W, int C_, int R, int vec_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);
  constexpr int V = 16 / sizeof(U);  // words a 16-byte chunk
  const int C = kC > 0 ? kC : C_;
  const int Hc = H / 2 + 4, Wc = W / 2 + 4, K = 12 * C, WC = W * C;
  const int bf = blockIdx.y, b = bf / F, f = bf - b * F;
  const int i0 = blockIdx.x * R, rows = min(R, Hc - i0);
  const int plane = pack_plane<U>(R, WC);
  unsigned fmask = 0;  // bit dt: frame f+dt-1 exists
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
    if (f + dt - 1 >= 0 && f + dt - 1 < F) fmask |= 1u << dt;
  // the slot map: slot k of a packed pixel reads tile word
  // tab[k] + 2*r*WC + (2*j-4)*C, or is zero (-1: its frame is missing)
  int* tab = reinterpret_cast<int*>(smem + 3 * (size_t)plane * sizeof(U));
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int s = k / C, c = k - s * C;
    const int py = s / 6, px = (s / 3) & 1, dt = s - (s / 3) * 3;
    tab[k] = fmask >> dt & 1 ? dt * plane + py * WC + px * C + c : -1;
  }

  // stage: packed rows [ilo, ihi) read input rows 2*ilo-4 .. 2*ihi-5, which
  // sit at tile rows 2*(ilo-i0) onwards; the band's other rows are pad
  const int ilo = max(i0, 2), ihi = min(i0 + rows, Hc - 2);
  if (ilo < ihi) {
    const int n = 2 * (ihi - ilo) * WC;
    for (int dt = 0; dt < 3; ++dt) {
      if (!(fmask >> dt & 1)) continue;
      const U* src = x + ((size_t)(b * F + f + dt - 1) * H + (2 * ilo - 4)) * WC;
      U* dst = tile + dt * plane + 2 * (ilo - i0) * WC;
      if (vec_in) {
        for (int q = threadIdx.x; q < n / V; q += kThreads)
          cp_async16(dst + q * V, src + q * V);
      } else {
        for (int q = threadIdx.x; q < n; q += kThreads) dst[q] = src[q];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // packed pixel (i0 + r, j) reads the input unless it lies in the pad
  auto inside = [&](int r, int j) {
    return i0 + r >= 2 && i0 + r < Hc - 2 && j >= 2 && j < Wc - 2;
  };

  // the band's output is one span of rows*Wc*K words from element e0; its
  // 16-byte chunks go by vector stores, the words before the first aligned
  // one (head) and after the last (tail) one by one
  const int row_words = Wc * K;
  const size_t e0 = ((size_t)bf * Hc + i0) * row_words;
  const int n_out = rows * row_words;
  const int head = min((int)((V - e0 % V) % V), n_out);
  const int nvec = (n_out - head) / V;
  const int tail0 = head + nvec * V;
  U* o = out + e0;
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int e = head + q * V;
    int r = e / row_words;
    const int rem = e - r * row_words;
    int j = rem / K, k = rem - j * K;
    int base = 2 * r * WC + (2 * j - 4) * C;
    bool ok = inside(r, j);
    union {
      uint4 v;
      U u[V];
    } pk;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int tk = tab[k];
      pk.u[v] = ok && tk >= 0 ? tile[base + tk] : U(0);
      if (++k == K) {  // the next packed pixel
        k = 0;
        base += 2 * C;
        if (++j == Wc) {
          j = 0;
          ++r;
          base = 2 * r * WC - 4 * C;
        }
        ok = inside(r, j);
      }
    }
    *reinterpret_cast<uint4*>(o + e) = pk.v;
  }
  if ((int)threadIdx.x < head + (n_out - tail0)) {  // fewer than 2V words
    const int e = (int)threadIdx.x < head ? (int)threadIdx.x
                                           : tail0 + ((int)threadIdx.x - head);
    const int r = e / row_words, rem = e - r * row_words;
    const int j = rem / K, tk = tab[rem - j * K];
    o[e] = inside(r, j) && tk >= 0 ? tile[2 * r * WC + (2 * j - 4) * C + tk] : U(0);
  }
}

// unpack's ring of staged packed frames: slot s holds packed frame s's
// interiors of R packed rows, RL = (W/2)*12C elements each, padded by 16
// bytes so that the slots start in other banks.
template <typename T>
__host__ __device__ __forceinline__ int unpack_slot(int R, int RL) {
  return R * RL + 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint16_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }

template <typename T, int kC>
__global__ void __launch_bounds__(kUThreads)
s2d2_unpack_kernel(const T* __restrict__ g, T* __restrict__ out, int F, int H,
                   int W, int C_, int R, int vec_in) {
  using U = decltype(bits_of(T()));
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte chunk
  const int C = kC > 0 ? kC : C_;
  const int Hc = H / 2 + 4, Wc = W / 2 + 4, K = 12 * C, WC = W * C;
  const int RL = (W / 2) * K, slot = unpack_slot<T>(R, RL);
  const int nfc = (F + kUFrames - 1) / kUFrames;
  const int band = blockIdx.x / nfc, fc = blockIdx.x - band * nfc;
  const int i0 = band * R, rows = min(R, H / 2 - i0);
  const int f0 = fc * kUFrames, f1 = min(F, f0 + kUFrames);
  const int b = blockIdx.y;
  // packed frames s0 .. slast feed output frames f0 .. f1-1
  const int s0 = max(f0 - 1, 0), slast = min(f1, F - 1);

  // packed frame s into slot s % kURing: the interiors (packed columns
  // 2 .. Wc-3) of packed rows i0+2 .., each one contiguous span of g
  auto stage = [&](int s) {
    if (s > slast) return;
    const T* src = g + (((size_t)(b * F + s) * Hc + i0 + 2) * Wc + 2) * K;
    T* dst = ring + (s % kURing) * slot;
    if (vec_in) {
      const int per = RL / V;
      for (int q = threadIdx.x; q < rows * per; q += kUThreads) {
        const int r = q / per, c = (q - r * per) * V;
        cp_async16(dst + r * RL + c, src + (size_t)r * Wc * K + c);
      }
    } else {
      for (int q = threadIdx.x; q < rows * RL; q += kUThreads) {
        const int r = q / RL, c = q - r * RL;
        dst[q] = src[(size_t)r * Wc * K + c];
      }
    }
  };
  for (int s = s0; s <= f0 + kUAhead; ++s) {  // one group a frame
    stage(s);
    cp_async_commit();
  }

  for (int f = f0; f < f1; ++f) {
    cp_async_wait<kUAhead - 1>();  // packed frame f+1 has landed
    __syncthreads();  // ... for every thread; frame f-2's slot is free
    stage(f + kUAhead + 1);
    cp_async_commit();

    // slot dt holds packed frame f+1-dt, where it exists
    const T* sl[3];
    unsigned fmask = 0;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int s = f + 1 - dt;
      sl[dt] = ring + ((s + kURing) % kURing) * slot + dt * C;
      if (s >= 0 && s < F) fmask |= 1u << dt;
    }
    // output element (row hr of the band, column w, channel c): its three
    // slots in packed row hr/2, pixel w/2, slot (2*(hr%2) + w%2)*3 + dt,
    // summed in fp32 in the order dt = 0, 1, 2 and rounded once
    auto sum_at = [&](int hr, int w, int c) {
      const int off = (hr >> 1) * RL + (w >> 1) * K + ((hr & 1) * 2 + (w & 1)) * 3 * C + c;
      float acc = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
        if (fmask >> dt & 1) acc += to_f<T>(sl[dt][off]);
      return from_f<T>(acc);
    };

    // the band's output rows 2*i0 .. of frame f are one span of
    // 2*rows*W*C elements from e0; its 16-byte chunks go by vector stores,
    // the elements before the first aligned one (head) and after the last
    // (tail) one by one
    const size_t e0 = ((size_t)(b * F + f) * H + 2 * i0) * WC;
    const int n_out = 2 * rows * WC;
    const int head = min((int)((V - e0 % V) % V), n_out);
    const int nvec = (n_out - head) / V;
    const int tail0 = head + nvec * V;
    T* o = out + e0;
    for (int q = threadIdx.x; q < nvec; q += kUThreads) {
      const int e = head + q * V;
      int hr = e / WC;
      const int rem = e - hr * WC;
      int w = rem / C, c = rem - w * C;
      union {
        uint4 v;
        U u[V];
      } pk;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        pk.u[v] = bits_of(sum_at(hr, w, c));
        if (++c == C) {
          c = 0;
          if (++w == W) {
            w = 0;
            ++hr;
          }
        }
      }
      *reinterpret_cast<uint4*>(o + e) = pk.v;
    }
    if ((int)threadIdx.x < head + (n_out - tail0)) {  // fewer than 2V elements
      const int e = (int)threadIdx.x < head ? (int)threadIdx.x
                                             : tail0 + ((int)threadIdx.x - head);
      const int hr = e / WC, rem = e - hr * WC, w = rem / C;
      o[e] = sum_at(hr, w, rem - w * C);
    }
  }
}

template <typename U, int kC>
int launch_pack_c(const U* x, U* out, int B, int F, int H, int W, int C,
                  int R, int vec_in, size_t smem, cudaStream_t stream) {
  auto kern = s2d2_pack_kernel<U, kC>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  const int Hc = H / 2 + 4;
  const dim3 grid((Hc + R - 1) / R, B * F);
  kern<<<grid, kThreads, smem, stream>>>(x, out, F, H, W, C, R, vec_in);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_pack(const void* x, void* out, int B, int F, int H, int W, int C,
                cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int WC = W * C, Hc = H / 2 + 4;
  const size_t row_bytes = (size_t)WC * sizeof(U);
  int R = (int)(kPackTileBytes / (6 * row_bytes));
  R = R < 1 ? 1 : (R > Hc ? Hc : R);
  const size_t smem = 3 * (size_t)pack_plane<U>(R, WC) * sizeof(U) + 12 * C * sizeof(int);
  const int vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 && row_bytes % 16 == 0;
  const U* xp = static_cast<const U*>(x);
  U* op = static_cast<U*>(out);
  return C == 3 ? launch_pack_c<U, 3>(xp, op, B, F, H, W, C, R, vec_in, smem, stream)
                : launch_pack_c<U, 0>(xp, op, B, F, H, W, C, R, vec_in, smem, stream);
}

template <typename T, int kC>
int launch_unpack_c(const T* g, T* out, int B, int F, int H, int W, int C,
                    int R, int vec_in, size_t smem, cudaStream_t stream) {
  auto kern = s2d2_unpack_kernel<T, kC>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  const int nfc = (F + kUFrames - 1) / kUFrames;
  const dim3 grid((H / 2 + R - 1) / R * nfc, B);
  kern<<<grid, kUThreads, smem, stream>>>(g, out, F, H, W, C, R, vec_in);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unpack(const void* g, void* out, int B, int F, int H, int W, int C,
                  cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr int V = 16 / sizeof(T);
  const int K = 12 * C, Wc = W / 2 + 4, RL = (W / 2) * K;
  int R = (int)(kUnpackSlotBytes / ((size_t)RL * sizeof(T)));
  R = R < 1 ? 1 : (R > H / 2 ? H / 2 : R);
  const size_t smem = (size_t)kURing * unpack_slot<T>(R, RL) * sizeof(T);
  const int vec_in = reinterpret_cast<uintptr_t>(g) % 16 == 0 && RL % V == 0 &&
                     (Wc * K) % V == 0 && (2 * K) % V == 0;
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  return C == 3 ? launch_unpack_c<T, 3>(gp, op, B, F, H, W, C, R, vec_in, smem, stream)
                : launch_unpack_c<T, 0>(gp, op, B, F, H, W, C, R, vec_in, smem, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Tensors are contiguous; the wrapper checks shapes, that H and W are even,
// that B*F fits the grid's y dimension and that one frame's elements fit an
// int. Both outputs must be 16-byte aligned (cudaErrorMisalignedAddress
// otherwise). Each returns the cudaError_t of its launch; 0 means launched.
extern "C" {

int s2d2_pack(int dtype, const void* x, void* out, int B, int F, int H, int W,
              int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_pack<uint16_t>(x, out, B, F, H, W, C, s)
                    : launch_pack<uint32_t>(x, out, B, F, H, W, C, s);
}

int s2d2_unpack(int dtype, const void* g, void* out, int B, int F, int H,
                int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_unpack<__nv_bfloat16>(g, out, B, F, H, W, C, s)
                    : launch_unpack<float>(g, out, B, F, H, W, C, s);
}

}  // extern "C"
