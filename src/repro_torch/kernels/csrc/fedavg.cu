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
// where the plain version rounds, and the results agree bitwise.
//
// Bound.  The pass is bytes-bound: it reads (C + 1) * N * itemsize bytes per
// grid point (C input rows, one output row) and does 2 * C flops per element,
// 0.5 flop per byte in float32, far below the card's ratio.
//
// Design.  Rows reach shared memory by Hopper's 1-D bulk async copy
// (cp.async.bulk ... mbarrier::complete_tx), so no thread spends registers
// or load instructions on them whatever their alignment.  N is cut into
// tiles of kRowBytes bytes a row; a work unit is one (grid point, tile), and
// a persistent grid of one block per SM walks the units.  A unit's C rows
// pass, in order, through a ring of one-row stages (64 KB: enough bytes in
// flight to cover HBM's latency from one SM, few enough that the first
// rows arrive soon after the launch): one producer thread waits for a
// stage's "empty" mbarrier, arms its "full" one with the copy's bytes,
// issues the copy and writes the row's RowHead (its element offsets and its
// weight, loaded a row ahead) before a second arrival releases the stage;
// the consumer warps wait on "full", add the row into registers (each
// element sums c = 0..C-1 left to right) and arrive on "empty".  So a
// consumer spends a few instructions a row on bookkeeping and the rest on
// its PER elements.  float32 with at most kDirectMaxC rows goes to
// fedavg_combine_kernel_direct instead (plain loads; see there why).
//
// Alignment.  A bulk copy needs a 16-byte aligned source, destination and
// size, and rows of a [C, N] tensor start on 16 bytes only when N is a
// multiple of 16 / itemsize, which the paper CNN's N = 4,583,146 is not.  So
// each row chunk [sb, eb) (byte addresses) is copied as its superset
// [align_down(sb, 128), align_up(eb, 128)) (whole 128-byte lines, which
// the copy engine moves faster than 16-byte aligned spans) into a slot of
// kSlotBytes, and consumers read element e at element `off` + e of the
// slot, off = (sb mod 128) / itemsize.  The superset is clamped to
// [align_up(x, 16), align_down(x_end, 16)): it never reads outside the
// tensor, and the few elements of the clamped head or tail of the whole
// tensor (< 16 bytes each) are read from global memory by the consumers.
// plan_chunk holds the arithmetic; the Python mirror
// kernels/fedavg.py::copy_plan is checked on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kRowBytes = 8192;             // one row's chunk of a tile
constexpr int kSlotBytes = kRowBytes + 128; // its 128-byte aligned superset
constexpr int kRingBytes = 64 * 1024;      // stages of one row's slot
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 16 * kMaxStages;  // full and empty mbarriers
constexpr int kHeadBytes = 16 * kMaxStages; // a RowHead a stage
constexpr int kMaxC = 12288;        // largest C the launch takes
constexpr int kDirectMaxC = 32;     // float32 with at most this many rows
constexpr int kDirectThreads = 256; // goes to fedavg_combine_kernel_direct

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// waits for the phase of `bar` with this parity to complete; a wait that
// lasts 2^34 clocks (over 8 s) traps, so a fault in the ring ends the
// launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, uint64_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// How one row chunk (elements [elem, elem + len) of the flat tensor that
// spans bytes [base, end)) reaches shared memory: `bytes` bytes from global
// `src` to byte `dst` of the row's slot (no copy when 0); the chunk's
// element e sits at element off + e of the slot when lo <= e < hi, and is
// read from global memory otherwise.
struct Chunk {
  uint64_t src;
  uint32_t dst, bytes;
  int off, lo, hi;
};

template <int ISZ>
__device__ __forceinline__ Chunk plan_chunk(uint64_t base, uint64_t end,
                                            int64_t elem, int len) {
  const uint64_t sb = base + (uint64_t)elem * ISZ;
  const uint64_t eb = sb + (uint64_t)len * ISZ;
  const uint64_t a0 = sb & ~127ull, a1 = (eb + 127) & ~127ull;
  const uint64_t head = (base + 15) & ~15ull, tail = end & ~15ull;
  const uint64_t cs = a0 > head ? a0 : head;
  uint64_t ce = a1 < tail ? a1 : tail;
  if (ce < cs) ce = cs;
  Chunk ch;
  ch.src = cs;
  ch.dst = (uint32_t)(cs - a0);
  ch.bytes = (uint32_t)(ce - cs);
  ch.off = (int)((sb - a0) / ISZ);
  ch.lo = cs > sb ? (int)((cs - sb) / ISZ) : 0;
  const uint64_t hi = ce > sb ? (ce - sb) / ISZ : 0;
  ch.hi = hi < (uint64_t)len ? (int)hi : len;
  return ch;
}

// a block's walk over the units u = blockIdx.x + i * gridDim.x, with the
// grid point g = u / tiles and the tile t = u % tiles kept without dividing
struct Walk {
  int64_t u, g, t;
  __device__ explicit Walk(int64_t tiles)
      : u(blockIdx.x), g(blockIdx.x / tiles), t(blockIdx.x % tiles) {}
  __device__ void next(int64_t tiles) {
    u += gridDim.x;
    t += gridDim.x;
    while (t >= tiles) {
      t -= tiles;
      ++g;
    }
  }
};

// what the consumers need of a stage's row besides its bytes, written by
// the producer
struct __align__(16) RowHead {
  int off, lo, hi;    // Chunk's
  float w;            // the row's weight
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fedavg_combine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int gn, int c, int64_t n,
                      int stages) {
  constexpr int kTile = kRowBytes / (int)sizeof(T);
  constexpr int PER = kTile / kConsumers;   // elements a consumer thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kMaxStages;
  RowHead* head = reinterpret_cast<RowHead*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + kHeadBytes;
  const int64_t tiles = (n + kTile - 1) / kTile, units = tiles * gn;
  const uint64_t base = reinterpret_cast<uint64_t>(x);
  const uint64_t end = base + (uint64_t)gn * c * n * sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < stages) {
    mbar_init(full0 + 8 * threadIdx.x, 2);   // the bytes, then the head
    mbar_init(empty0 + 8 * threadIdx.x, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {              // the producer
    if (lane != 0) return;
    int k = 0;
    Walk walk(tiles);
    // the row's weight, loaded a row ahead and used after its copy is out
    float w_next = walk.u < units ? __ldg(w + walk.g * c) : 0.0f;
    for (; walk.u < units; walk.next(tiles)) {
      const int64_t g = walk.g, t0 = walk.t * kTile;
      const int len = (int)(n - t0 < kTile ? n - t0 : kTile);
      for (int r = 0; r < c; ++r, ++k) {
        const int s = k % stages;
        mbar_wait(empty0 + 8 * s, ((k / stages) & 1) ^ 1);
        const Chunk ch =
            plan_chunk<sizeof(T)>(base, end, (g * c + r) * n + t0, len);
        mbar_arrive_expect_tx(full0 + 8 * s, ch.bytes);
        if (ch.bytes)
          bulk_load(smem_u32(ring + s * kSlotBytes) + ch.dst, ch.src,
                    ch.bytes, full0 + 8 * s);
        head[s] = RowHead{ch.off, ch.lo, ch.hi, w_next};
        mbar_arrive(full0 + 8 * s);          // releases the head
        if (r + 1 < c) {
          w_next = __ldg(w + g * c + r + 1);
        } else if (walk.u + gridDim.x < units) {
          Walk after = walk;
          after.next(tiles);
          w_next = __ldg(w + after.g * c);
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x;                // consumer thread
  int k = 0;
  for (Walk walk(tiles); walk.u < units; walk.next(tiles)) {
    const int64_t g = walk.g, t0 = walk.t * kTile;
    const int len = (int)(n - t0 < kTile ? n - t0 : kTile);
    float acc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] = 0.0f;
    for (int r = 0; r < c; ++r, ++k) {
      const int s = k % stages;
      mbar_wait(full0 + 8 * s, (k / stages) & 1);
      const RowHead h = head[s];
      const float wr = h.w;
      const T* sx = reinterpret_cast<const T*>(ring + s * kSlotBytes) + h.off;
      if (h.lo == 0 && h.hi == kTile) {      // a whole tile, all in the slot
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const float v = to_f32(sx[j * kConsumers + ct]);
          acc[j] = r == 0 ? __fmul_rn(v, wr)
                          : __fadd_rn(acc[j], __fmul_rn(v, wr));
        }
      } else {                               // ragged, or a clamped end
        const T* gx = x + (g * c + r) * n + t0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int e = j * kConsumers + ct;
          if (e < len) {
            const float v = to_f32(e >= h.lo && e < h.hi ? sx[e] : gx[e]);
            acc[j] = r == 0 ? __fmul_rn(v, wr)
                            : __fadd_rn(acc[j], __fmul_rn(v, wr));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    T* og = out + g * n + t0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = j * kConsumers + ct;
      if (e < len) og[e] = from_f32<T>(acc[j]);
    }
  }
}

// The float32 combine of few rows (C <= kDirectMaxC) with plain loads, as
// the port's first version did it: thread tid owns elements tile + j *
// kDirectThreads + tid, j < PER, and loops over the C rows with PER
// independent loads a row, so each load instruction of a warp reads 32
// consecutive elements whatever N's alignment.  Its blocks start loading at
// once, where the ring's first rows arrive microseconds after the launch:
// at the paper CNN's N the ring was 3 % slower at C = 5, level at C = 10
// and 20 and 3 % faster at C = 100 (benchmarks/torch_kernel_pair.py, H100).
__global__ void __launch_bounds__(kDirectThreads)
fedavg_combine_kernel_direct(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int c, int64_t n) {
  constexpr int PER = 4;               // 16 bytes of output a thread
  extern __shared__ float sw[];
  const int g = blockIdx.y;
  for (int i = threadIdx.x; i < c; i += kDirectThreads)
    sw[i] = w[(int64_t)g * c + i];
  __syncthreads();

  const float* xg = x + (int64_t)g * c * n;
  float* og = out + (int64_t)g * n;
  const int64_t tile = (int64_t)blockIdx.x * (kDirectThreads * PER);
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t e = tile + (int64_t)j * kDirectThreads + threadIdx.x;
    acc[j] = e < n ? __fmul_rn(xg[e], sw[0]) : 0.0f;
  }
#pragma unroll 2
  for (int r = 1; r < c; ++r) {
    const float* row = xg + (int64_t)r * n;
    const float wr = sw[r];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t e = tile + (int64_t)j * kDirectThreads + threadIdx.x;
      if (e < n) acc[j] = __fadd_rn(acc[j], __fmul_rn(row[e], wr));
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int64_t e = tile + (int64_t)j * kDirectThreads + threadIdx.x;
    if (e < n) og[e] = acc[j];
  }
}

int sm_count(int dev) {
  static int count[64] = {};
  if (!count[dev])
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <typename T>
int launch(const void* x, const float* w, void* out, int g, int c, int64_t n,
           cudaStream_t stream) {
  constexpr int64_t kTile = kRowBytes / (int)sizeof(T);
  static bool ready[64] = {};          // the smem limit, raised once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(fedavg_combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBarBytes + kHeadBytes + kRingBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  int stages = kRingBytes / kSlotBytes;
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t smem = kBarBytes + kHeadBytes + (size_t)stages * kSlotBytes;
  const int64_t units = (n + kTile - 1) / kTile * g;
  const int sms = sm_count(dev);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  fedavg_combine_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), g, c, n, stages);
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
  if (bf16) return launch<__nv_bfloat16>(x, w, out, g, c, n, st);
  if (c <= kDirectMaxC) {
    constexpr int64_t kTile = kDirectThreads * 4;
    const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)g);
    fedavg_combine_kernel_direct<<<grid, kDirectThreads,
                                   (size_t)c * sizeof(float), st>>>(
        static_cast<const float*>(x), w, static_cast<float*>(out), c, n);
    return (int)cudaGetLastError();
  }
  return launch<float>(x, w, out, g, c, n, st);
}

int fedavg_combine_max_c() { return kMaxC; }

}  // extern "C"
