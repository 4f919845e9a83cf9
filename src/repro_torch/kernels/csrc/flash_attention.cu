// Causal (or full) grouped-query attention forward for NVIDIA Hopper (sm_90a):
//   o[b, i, h, g] = sum_j softmax_j(q[b, i, h, g] . k[b, j, h] * dh^-0.5) v[b, j, h]
//   q: [B, Sq, KV, G, dh], k, v: [B, Skv, KV, dh], o like q, dh in {32, 64, 128}
// over the keys j <= i (causal, top-left aligned) or all keys.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_fwd (body
//   _flash_fwd_kernel)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::flash_attention_ref does.
//
// Semantics kept from the TPU kernel.  q, k and v (float32 or bfloat16) are
// read as float32; the logit is the float32 dot product times dh^-0.5;
// masked logits are -1e30; the running max m starts at -1e30, and m, the
// running sum l and the accumulator stay in float32; the output is
// acc / max(l, 1e-30) in q's dtype.  Key tiles entirely above the diagonal
// are skipped.  Sq and Skv need not be multiples of any tile: the ragged
// edge is masked and nothing past either end is read.  Exponentials are
// expf (the accurate one; the build has no fast-math flag).
//
// Bound.  The causal forward does 2 * 2 * B * H * Sq * Skv * dh / 2 float
// operations (H = KV * G) on the bytes of q, k, v and o: for smollm-135m at
// (B, S) = (4, 4096), 7.73e10 operations against ~50 MB, so it is bound by
// operations (0.078 ms at 989 TFLOP/s on bf16 tensor cores, 0.015 ms for the
// bytes at 3.35 TB/s).  This kernel does its products on the CUDA cores in
// float32 (67 TFLOP/s), so it cannot come nearer than ~15x that bound;
// mma.sync / wgmma tiles are later work.  Measured on an H100 80GB HBM3
// (700 W): 5.2 ms at that shape, 1.5 % of the bound (PERF.md).
//
// Design (simple first).  One block per (tile of query rows, b, kv head).
// A block's rows are consecutive (position, q head) pairs of one kv head, so
// every K/V tile it loads into shared memory serves all G query heads of
// that kv head.  kParts = dh / 32 threads share a row: each holds 32 dims of
// q and of the accumulator in registers, computes its part of each dot
// product, and the parts are summed with xor shuffles, so every thread of a
// row sees the same logits and the same m and l.  Each 32-dim segment of a
// shared-memory row is padded to 36 floats, so the parts of one warp read
// distinct banks with 16-byte loads.  Per tile of kBK keys a thread keeps
// the kBK logits in registers and applies the online-softmax update once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;             // keys per shared-memory tile
constexpr int kSeg = 36;            // floats per padded 32-dim segment
constexpr float kNegLogit = -1e30f;

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int kv, int g, int causal, float scale) {
  constexpr int kParts = DH / 32;             // threads per query row
  constexpr int kRows = kThreads / kParts;    // query rows per block
  constexpr int kStride = kParts * kSeg;      // floats per shared key row
  __shared__ __align__(16) float ks[kBK * kStride];
  __shared__ __align__(16) float vs[kBK * kStride];

  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int64_t rows = (int64_t)sq * g;       // (position, q head) rows
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t row = row0 + tid / kParts;
  const bool live = row < rows;
  const int64_t rr = live ? row : rows - 1;   // idle rows shadow the last
  const int pos = (int)(rr / g);
  const int head = (int)(rr % g);
  const int b = blockIdx.y / kv;
  const int h = blockIdx.y % kv;

  const int64_t q_off =
      ((((int64_t)b * sq + pos) * kv + h) * g + head) * DH + part * 32;
  float qr[32], acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    qr[d] = to_f32(q[q_off + d]);
    acc[d] = 0.0f;
  }
  float m = kNegLogit, l = 0.0f;

  // keys the block needs: all, or up to its last row's position (causal)
  const int64_t last_row = (row0 + kRows < rows ? row0 + kRows : rows) - 1;
  int kv_end = skv;
  if (causal && (int)(last_row / g) + 1 < kv_end)
    kv_end = (int)(last_row / g) + 1;
  const int64_t kv_base = ((int64_t)b * skv * kv + h) * DH;   // [b, 0, h, 0]
  const int64_t kv_step = (int64_t)kv * DH;                   // next position

  for (int t0 = 0; t0 < kv_end; t0 += kBK) {
    __syncthreads();                          // the last tile is consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int j = e / DH, d = e % DH;
      const int t = t0 + j;
      const int idx = j * kStride + (d / 32) * kSeg + (d % 32);
      float kval = 0.0f, vval = 0.0f;
      if (t < skv) {
        kval = to_f32(k[kv_base + t * kv_step + d]);
        vval = to_f32(v[kv_base + t * kv_step + d]);
      }
      ks[idx] = kval;
      vs[idx] = vval;
    }
    __syncthreads();

    float sc[kBK];
    float tile_max = kNegLogit;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr =
          reinterpret_cast<const float4*>(ks + j * kStride + part * kSeg);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 kk = kr[c];
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int t = t0 + j;
      const bool ok = t < skv && (!causal || t <= pos);
      sc[j] = ok ? dot * scale : kNegLogit;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < 32; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* vr =
          reinterpret_cast<const float4*>(vs + j * kStride + part * kSeg);
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < 32; ++d) o[q_off + d] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int kv, int g, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kRows = kThreads / (DH / 32);
  const int64_t rows = (int64_t)sq * g;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)(b * kv));
  flash_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, kv, g, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b,
              int sq, int skv, int kv, int g, int dh, int causal,
              float scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the attention forward on `stream`: q [b, sq, kv, g, dh], k and v
// [b, skv, kv, dh], o like q, all contiguous, float32 if bf16 == 0, else
// bfloat16; dh in {32, 64, 128}; `scale` multiplies the float32 logits.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for sizes
// the kernel does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int sq, int skv, int kv, int g,
                           int dh, int causal, float scale, int bf16,
                           void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kv < 1 || g < 1 ||
      (long long)b * kv > 65535 || (long long)sq * g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, b, sq, skv, kv, g, dh,
                                         causal, scale, st)
              : launch_dh<float>(q, k, v, o, b, sq, skv, kv, g, dh, causal,
                                 scale, st);
}

}  // extern "C"
