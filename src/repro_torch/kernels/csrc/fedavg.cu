// Weighted FedAvg combine for a [G] grid of aggregations, for NVIDIA Hopper
// (sm_90a):
//   out[g, i] = sum_c w[g, c] * x[g, c, i]     x: [G, C, N], w: [G, C] f32
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/fedavg.py::fedavg_combine (body _fedavg_kernel)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::fedavg_combine_ref does.
//
// Arithmetic.  x is float32 or bfloat16 and is read as float32; for each
// element acc = x[0]*w[0], then acc = acc + x[c]*w[c] for c = 1..C-1, in that
// order, and the result is written in x's dtype (bf16 round-to-nearest-even).
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn),
// so nvcc cannot contract a product and a sum into an FMA: the kernel rounds
// where the plain version rounds, and float32 results agree bitwise.
//
// Bound.  The pass is bytes-bound: it reads (C + 1) * N * itemsize bytes per
// grid point (C input rows, one output row) and does 2 * C flops per element,
// 0.5 flop per byte in float32, far below the card's ratio.
//
// Design (simple first).  A 2-D grid: y is the grid point g, x walks N in
// tiles of kThreads * PER elements.  The block reads its C weights once
// into shared memory.  Each thread owns PER = 16 / sizeof(T) elements of
// the tile (4 f32 or 8 bf16: 16 bytes of output), element j at
// tile + j * kThreads + tid, and loops over the C rows with PER independent
// loads per row; so each load instruction of a warp reads 32 consecutive
// elements (128 bytes in float32) whatever N's alignment.  Rows of a [C, N] buffer start
// on a 16-byte boundary only when N is a multiple of 4 (f32) or 8 (bf16),
// which the paper CNN's N = 4,583,146 is not, so the kernel does not use
// 16-byte vector loads.  The ragged tail of the last tile is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 12288;        // weights of one grid point: 48 KB of smem

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
fedavg_combine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int c, int64_t n) {
  extern __shared__ float sw[];
  const int g = blockIdx.y;
  for (int i = threadIdx.x; i < c; i += kThreads) sw[i] = w[(int64_t)g * c + i];
  __syncthreads();

  const T* xg = x + (int64_t)g * c * n;
  T* og = out + (int64_t)g * n;
  const int64_t tile = (int64_t)blockIdx.x * (kThreads * PER);
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t e = tile + (int64_t)j * kThreads + threadIdx.x;
    acc[j] = e < n ? __fmul_rn(to_f32(xg[e]), sw[0]) : 0.0f;
  }
#pragma unroll 2
  for (int r = 1; r < c; ++r) {
    const T* row = xg + (int64_t)r * n;
    const float wr = sw[r];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t e = tile + (int64_t)j * kThreads + threadIdx.x;
      if (e < n) acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(row[e]), wr));
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t e = tile + (int64_t)j * kThreads + threadIdx.x;
    if (e < n) og[e] = from_f32<T>(acc[j]);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int g, int c, int64_t n,
           cudaStream_t stream) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int64_t kTile = kThreads * PER;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)g);
  const size_t smem = (size_t)c * sizeof(float);
  fedavg_combine_kernel<T, PER><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), c, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the combine on `stream`: x [g, c, n] (float32 if bf16 == 0, else
// bfloat16), contiguous; w [g, c] float32; out [g, n] in x's dtype.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for bad sizes).
int fedavg_combine_launch(const void* x, const float* w, void* out, int g,
                          int c, long long n, int bf16, void* stream) {
  if (g < 1 || g > 65535 || c < 1 || c > kMaxC || n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, g, c, n, st)
              : launch<float>(x, w, out, g, c, n, st);
}

int fedavg_combine_max_c() { return kMaxC; }

}  // extern "C"
