// RG-LRU linear-recurrence scan for NVIDIA Hopper (sm_90a):
//   y[b, t, w] = a[b, t, w] * y[b, t - 1, w] + x[b, t, w],   y[b, -1, w] = 0
// over a, x: [B, T, W] (the recurrence's "b" is called x here, to keep it
// apart from the batch index).
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/rg_lru.py::rg_lru_scan (body _rg_lru_kernel)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::rg_lru_ref does.
//
// Arithmetic.  a and x are float32 or bfloat16 and are read as float32; the
// carry h is float32, and each step is one fused multiply-add rounded once,
// h = __fmaf_rn(a, h, x), as the plain version's torch.addcmul(x, a, h)
// rounds and as XLA contracts a * h + x in the JAX package's scan.  y is
// written in a's dtype (bfloat16 round-to-nearest-even).
//
// Bound.  Bytes: a and x read once, y written once, 3 * B * T * W *
// itemsize bytes, and 2 float operations per element (0.17 per byte in
// float32): far below the card's ratio.  At the griffin prefill's
// (4, 4096, 4096) float32 that is 805 MB, 0.240 ms at 3.35 TB/s.
//
// Design (simple first).  The recurrence is sequential in T; the TPU kernel
// walks T in blocks with the carry in VMEM scratch.  Here each thread owns
// one (b, w) lane for the whole of T, and the carry stays in a register.
// Consecutive threads take consecutive w, so each warp's loads and stores
// of one step cover 32 consecutive elements.  The FMA chain is one
// dependent operation per step; what would serialise is the memory latency
// of each step's loads.  So the loop runs in chunks of kAhead steps: the
// loads of the next chunk are issued (into registers) before the FMAs and
// stores of the current one, and stay in flight while it computes.
// Offsets are 64-bit, ((b * T + t) * W + w); the ragged edge w >= W is
// masked, and nothing is asserted about divisibility.  With 16,384 lanes at
// the main path's shape only 128 blocks of 128 threads run, a few percent
// of the card's resident threads: the kernel is latency-bound there.  A
// chunked scan over T with a carry fix-up would fill the card (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;          // steps whose loads are in flight at once

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ x,
              T* __restrict__ y, int t_len, int w_len) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= w_len) return;
  const int64_t base = (int64_t)blockIdx.y * t_len * w_len + w;
  const T* pa = a + base;
  const T* px = x + base;
  T* py = y + base;

  float ca[kAhead], cx[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const bool ok = j < t_len;
    ca[j] = ok ? to_f32(pa[(int64_t)j * w_len]) : 0.0f;
    cx[j] = ok ? to_f32(px[(int64_t)j * w_len]) : 0.0f;
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < t_len; t0 += kAhead) {
    const int t1 = t0 + kAhead;
    float na[kAhead], nx[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool ok = t1 + j < t_len;
      const int64_t off = (int64_t)(t1 + j) * w_len;
      na[j] = ok ? to_f32(pa[off]) : 0.0f;
      nx[j] = ok ? to_f32(px[off]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j < t_len) {
        h = __fmaf_rn(ca[j], h, cx[j]);
        py[(int64_t)(t0 + j) * w_len] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ca[j] = na[j];
      cx[j] = nx[j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* x, void* y, int b, int t, int w,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((w + kThreads - 1) / kThreads), (unsigned)b);
  rg_lru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y),
      t, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the scan on `stream`: a, x, y [b, t, w], contiguous, all float32 if
// bf16 == 0, else all bfloat16.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for bad sizes).
int rg_lru_launch(const void* a, const void* x, void* y, int b, int t, int w,
                  int bf16, void* stream) {
  if (b < 1 || b > 65535 || t < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, x, y, b, t, w, st)
              : launch<float>(a, x, y, b, t, w, st);
}

}  // extern "C"
