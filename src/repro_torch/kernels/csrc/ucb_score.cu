// Naive-UCB (Eq. 4) score of every arm, for NVIDIA Hopper (sm_90a):
//
//   score = -(sum / max(n, 1)) / alpha + sqrt(log max(total, 2) / (2 max(n, 1)))
//   score = BIG (1e12)                                        where n == 0
//
// over a [G, K] grid of bandit states with one `total` per row.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/ucb_score.py::ucb_scores  (_ucb_kernel;
//   src/repro/kernels/ucb_score.py:39)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::ucb_scores_ref does.  Every division, product,
// sum and square root is an explicitly rounded intrinsic (__fdiv_rn, ...),
// so nvcc contracts nothing into an FMA and each operation rounds where the
// plain version's does; the log is logf, as PyTorch's float log on the card.
//
// Bound.  Elementwise and memory-bound: 12 bytes per arm (a float sum and
// an int count in, a float score out), ~10 float operations per arm; at
// (G, K) = (1, 10^6) 12 MB, 3.6 us at 3.35 TB/s.
//
// Design.  The Pallas kernel tiles [K] into 4096-lane VMEM blocks.  Here
// one thread scores one arm: blocks of 256 threads tile K along x and the
// grid rows along y.  Thread 0 computes the row's log max(total, 2) once,
// into shared memory, while the block's loads of the sums and counts are in
// flight (the loads go out before the barrier; after it, two memory round
// trips would run in a row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e12f;

__global__ void __launch_bounds__(kThreads)
ucb_score_kernel(const float* __restrict__ sums,
                 const int32_t* __restrict__ n_sel,
                 const int32_t* __restrict__ total, float* __restrict__ out,
                 long long k, float alpha) {
  __shared__ float log_total_s;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const size_t i = (size_t)blockIdx.y * k + j;
  // every thread reaches the barrier; those past the row's end load nothing
  const float sum = j < k ? sums[i] : 0.0f;
  const int n = j < k ? n_sel[i] : 0;
  if (threadIdx.x == 0)
    log_total_s = logf(fmaxf((float)total[blockIdx.y], 2.0f));
  __syncthreads();
  if (j >= k) return;
  const float nf = fmaxf((float)n, 1.0f);
  const float mean = __fdiv_rn(sum, nf);
  const float bonus =
      __fsqrt_rn(__fdiv_rn(log_total_s, __fmul_rn(2.0f, nf)));
  const float score = __fadd_rn(-__fdiv_rn(mean, alpha), bonus);
  out[i] = n == 0 ? kBig : score;
}

}  // namespace

extern "C" {

// Launch on `stream`: sums [g, k] float32, n_sel [g, k] int32, total [g]
// int32, out [g, k] float32, all contiguous.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for bad sizes).
int ucb_score_launch(const float* sums, const int32_t* n_sel,
                     const int32_t* total, float* out, int g, long long k,
                     float alpha, void* stream) {
  if (g < 1 || g > 65535 || k < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((k + kThreads - 1) / kThreads), (unsigned)g);
  ucb_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sums, n_sel, total, out, k, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
