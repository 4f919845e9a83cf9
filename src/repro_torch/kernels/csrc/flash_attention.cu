// Causal (or full) grouped-query attention forward in float32 for NVIDIA
// Hopper (sm_90a), on the CUDA cores:
//   o[b, i, h, g] = sum_j softmax_j(q[b, i, h, g] . k[b, j, h] * dh^-0.5) v[b, j, h]
//   q: [B, Sq, KV, G, dh], k, v: [B, Skv, KV, dh], o like q, all float32,
//   dh in {32, 64, 128}
// over the keys j <= i (causal, top-left aligned) or all keys.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_fwd (body
//   _flash_fwd_kernel)
// for float32 inputs, and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::flash_attention_ref does.  Bfloat16 inputs go
// to kernels/csrc/flash_attention_sm90.cu (wgmma on the tensor cores).  The
// products stay here in float32 FMAs: TF32 tensor cores keep ~3 decimal
// digits and would not hold the float32 tolerance (rtol 2e-5 / atol 1e-5)
// nor the JAX package's contract.
//
// Semantics kept from the TPU kernel.  The logit is the float32 dot product
// times dh^-0.5; masked logits are -1e30; the running max m starts at
// -1e30, and m, the running sum l and the accumulator stay in float32; the
// output is acc / max(l, 1e-30).  Key tiles entirely above the diagonal are
// skipped.  Sq and Skv need not be multiples of any tile: the ragged edge
// is masked and nothing past either end is read.  Exponentials are expf
// (the accurate one; the build has no fast-math flag).
//
// Bound.  The causal forward does 2 * 2 * B * H * Sq * Skv * dh / 2 float
// operations (H = KV * G) on the bytes of q, k, v and o: for smollm-135m at
// (B, S) = (4, 4096), 7.73e10 operations against ~100 MB in float32, so it
// is bound by operations (1.15 ms at 67 TFLOP/s on the CUDA cores, 0.03 ms
// for the bytes at 3.35 TB/s).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;             // keys per shared-memory tile
constexpr int kSeg = 36;            // floats per padded 32-dim segment
constexpr float kNegLogit = -1e30f;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int sq,
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
    qr[d] = q[q_off + d];
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
        kval = k[kv_base + t * kv_step + d];
        vval = v[kv_base + t * kv_step + d];
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
    for (int d = 0; d < 32; ++d) o[q_off + d] = acc[d] / denom;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int kv, int g, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kRows = kThreads / (DH / 32);
  const int64_t rows = (int64_t)sq * g;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)(b * kv));
  flash_attention_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, kv, g,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the float32 attention forward on `stream`: q [b, sq, kv, g, dh],
// k and v [b, skv, kv, dh], o like q, all contiguous float32; dh in
// {32, 64, 128}; `scale` multiplies the logits.  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for sizes the kernel does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int sq, int skv, int kv, int g,
                           int dh, int causal, float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kv < 1 || g < 1 ||
      (long long)b * kv > 65535 || (long long)sq * g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    case 64:
      return launch<64>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, o, b, sq, skv, kv, g, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
