// Local top-S of the segmented (client-sharded) selection, for NVIDIA
// Hopper (sm_90a): for every row of a [R, C] score matrix (R = G grid
// points x P shards), S masked argmax steps over the row's valid entries.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/bandit_round.py::topk_slots_pallas  (_topk_slots_kernel)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::local_topk_ref does: step i takes the first
// maximum of where(live, score, -inf) over the whole row (live = valid and
// not yet picked); the pick counts only if that entry is live, giving
// (score, slot), else (-inf, -1).  So, as in the reference, a row whose
// first maximum is a dead entry (all live scores -inf) ends exhausted.
// NaN ranks above every number, as argmax ranks it.  Only comparisons
// happen, so the result equals the plain version bitwise.
//
// Design.  The Pallas kernel holds the [C] slice in VMEM and runs S argmax
// passes over it.  At K = 10^6 a row has C = 10^5 entries (500 KB with the
// validity bytes), more than a thread block's shared memory, so here one
// thread block serves one row and streams the row from global memory
// (L2-resident after the first pass) in each of the S steps; only the
// picked set lives on chip, as a bitmap of C bits in dynamic shared memory
// (12.5 KB at C = 10^5).  Each step is a strided scan, in which each thread
// keeps its first maximum and issues 8 loads before comparing (so that the
// scan does not wait one memory latency per entry), and a block-wide
// (value, lowest index) reduction: warp shuffles, then one warp over the
// per-warp winners.  Thread 0 records the pick and marks it taken before
// the next step.
//
// Bound.  The work is S passes of 5 bytes per entry; the least the card
// must move is each input once (C * 5 bytes per row) and the S outputs.
// With R blocks of one SM each and S dependent steps, the kernel is bound
// by one SM's load rate and the S barrier-separated reductions, not by the
// card's memory rate: a later version can split long rows over several
// blocks, or keep each thread's own top-S in registers in one pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kUnroll = 8;          // loads in flight per thread in a scan

// (value, index) order of argmax: NaN first, then larger value, then lower
// index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void topk_slots_kernel(const float* __restrict__ score,
                                  const uint8_t* __restrict__ valid,
                                  float* __restrict__ vals,
                                  int32_t* __restrict__ slots, int c, int s) {
  extern __shared__ unsigned int taken[];   // ceil(C / 32) words
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthreads + 31) >> 5;
  const size_t row = blockIdx.x;
  const float* sc = score + row * c;
  const uint8_t* va = valid + row * c;
  const int words = (c + 31) >> 5;

  for (int w = tid; w < words; w += nthreads) taken[w] = 0u;
  __syncthreads();

  // this thread's entries j = tid + n * nthreads, ranked in increasing j
  // (so the thread keeps its first maximum); loads issued kUnroll at a time
  auto rank = [&](int j, float score_j, uint8_t valid_j, float& bv, int& bi) {
    const bool live = valid_j && !((taken[j >> 5] >> (j & 31)) & 1u);
    const float v = live ? score_j : -INFINITY;
    if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  };
  for (int i = 0; i < s; ++i) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    int j = tid;
    for (; j + (kUnroll - 1) * nthreads < c; j += kUnroll * nthreads) {
      float sv[kUnroll];
      uint8_t vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sv[u] = sc[j + u * nthreads];
        vv[u] = va[j + u * nthreads];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) rank(j + u * nthreads, sv[u], vv[u], bv, bi);
    }
    for (; j < c; j += nthreads) rank(j, sc[j], va[j], bv, bi);
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        const int x = bi;   // < c: every entry of the row was ranked
        const bool ok = va[x] && !((taken[x >> 5] >> (x & 31)) & 1u);
        vals[row * s + i] = ok ? sc[x] : -INFINITY;
        slots[row * s + i] = ok ? x : -1;
        if (ok) taken[x >> 5] |= 1u << (x & 31);
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int c) { return (size_t)((c + 31) / 32) * sizeof(unsigned int); }

}  // namespace

extern "C" {

// Launch on `stream`: score [rows, c] float32, valid [rows, c] bytes (0/1),
// vals [rows, s] float32, slots [rows, s] int32, all contiguous.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for bad sizes).
int topk_slots_launch(const float* score, const uint8_t* valid, float* vals,
                      int32_t* slots, long long rows, int c, int s,
                      void* stream) {
  if (rows < 1 || rows > INT_MAX || c < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(c);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((c + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  topk_slots_kernel<<<(unsigned)rows, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(score, valid, vals,
                                                           slots, c, s);
  return (int)cudaGetLastError();
}

size_t topk_slots_smem_bytes(int c) { return smem_bytes(c); }

}  // extern "C"
