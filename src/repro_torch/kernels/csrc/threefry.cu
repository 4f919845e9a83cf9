// Threefry-2x32 counter-based random numbers for NVIDIA Hopper (sm_90a):
// the generator behind jax.random (jax/_src/prng.py, threefry2x32 with
// jax_threefry_partitionable), so the port draws the JAX package's random
// numbers from the same seeds.
//
// Replaces no TPU kernel: the JAX package leaves threefry to XLA.  The port
// adds it so that a sweep draws JAX's streams from the seed alone, and so
// that a rank draws only its own rows and counters (each value depends on
// its key and its counter only).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::threefry_ref.
//
// What it computes.  For N keys (k0, k1) and n counters from an offset,
// key row i and counter j hash the 64-bit counter c = offset +
// row_offset[i] + j, split as (x0, x1) = (c >> 32, c mod 2^32), through
// 20 rounds of Threefry-2x32 (rotations 13, 15, 26, 6 and 17, 29, 16, 24,
// a key injection every 4 rounds) to (y0, y1), and writes one of
//   mode 0: bits     y0 ^ y1 (uint32)                    out [N, n]
//   mode 1: pairs    (y0, y1)                            out [N, n, 2]
//   mode 2: uniform  f = float(bits >> 9 | 0x3F800000) - 1 in [0, 1),
//                    max(lo, f * span + lo)  (float32)   out [N, n]
// The uniform's multiply-add is one __fmaf_rn, rounded once: XLA:CPU
// contracts jax's floats * (maxval - minval) + minval into an FMA (bitwise
// so on 2,000 keys x 50 draws at four pairs of bounds), and the plain
// version rounds it once with torch.addcmul.  The subtraction of 1 is
// exact.
//
// Bound.  Each output is one store of 4 or 8 bytes; the inputs are 8 bytes
// a key row, read once.  The least time is the written bytes over the
// card's 3.35 TB/s.  Each output also costs about 80 integer operations in
// registers (20 rounds of add, funnel shift and xor, six key injections)
// and a 64-bit division of the flat index: at the memory rate that would
// take some 70 TOP/s of 32-bit integer work, more than the card's integer
// pipes give, so the measured time can sit well above the byte bound.
//
// Design (simple first).  One thread per (key, counter); consecutive
// threads take consecutive counters of one key row, so a warp's stores
// cover 32 consecutive outputs.  A grid-stride loop over the flat N * n
// index covers any size with a bounded grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define TF_ROUND(r)   \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND

template <int kMode>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint32_t* __restrict__ keys,
                const int64_t* __restrict__ row_offsets, int64_t n_keys,
                int64_t n, uint64_t offset, float lo, float span,
                void* __restrict__ out) {
  const int64_t total = n_keys * n;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx / n;
    const int64_t j = idx - row * n;
    uint64_t c = offset + (uint64_t)j;
    if (row_offsets != nullptr) c += (uint64_t)row_offsets[row];
    uint32_t x0 = (uint32_t)(c >> 32);
    uint32_t x1 = (uint32_t)c;
    threefry2x32(keys[2 * row], keys[2 * row + 1], x0, x1);
    if (kMode == 0) {
      static_cast<uint32_t*>(out)[idx] = x0 ^ x1;
    } else if (kMode == 1) {
      static_cast<uint2*>(out)[idx] = make_uint2(x0, x1);
    } else {
      const uint32_t bits = x0 ^ x1;
      const float f =
          __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
      static_cast<float*>(out)[idx] = fmaxf(lo, __fmaf_rn(f, span, lo));
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: keys [n_keys, 2] uint32, row_offsets [n_keys] int64 or
// null, out as the mode says (contiguous, 8-byte aligned for mode 1).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for bad
// arguments).
int threefry_launch(const void* keys, const void* row_offsets,
                    long long n_keys, long long n, unsigned long long offset,
                    int mode, float lo, float span, void* out,
                    void* stream) {
  if (n_keys < 1 || n < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const long long total = n_keys * n;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const int64_t* ro = static_cast<const int64_t*>(row_offsets);
  if (mode == 0)
    threefry_kernel<0><<<blocks, kThreads, 0, st>>>(k, ro, n_keys, n, offset,
                                                     lo, span, out);
  else if (mode == 1)
    threefry_kernel<1><<<blocks, kThreads, 0, st>>>(k, ro, n_keys, n, offset,
                                                     lo, span, out);
  else
    threefry_kernel<2><<<blocks, kThreads, 0, st>>>(k, ro, n_keys, n, offset,
                                                     lo, span, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
