// Causal (or full) grouped-query attention forward in bfloat16 for NVIDIA
// Hopper (sm_90a), on the tensor cores:
//   o[b, i, h, g] = sum_j softmax_j(q[b, i, h, g] . k[b, j, h] * dh^-0.5) v[b, j, h]
//   q: [B, Sq, KV, G, dh], k, v: [B, Skv, KV, dh], o like q, all bfloat16,
//   dh in {32, 64, 128}
// over the keys j <= i + q_offset (causal: query i at position q_offset + i,
// top-left aligned at q_offset = 0) or all keys.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_fwd (body
//   _flash_fwd_kernel; src/repro/kernels/flash_attention.py:81)
// for bfloat16 inputs, and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::flash_attention_ref does.  Float32 inputs go
// to kernels/csrc/flash_attention.cu (3xTF32 on the tensor cores: one TF32
// product would not hold the float32 tolerance, three do).
//
// Semantics kept from the TPU kernel.  The logits are float32 dot products
// of the bfloat16 values (exact products, float32 sums in the tensor
// cores) times dh^-0.5; masked logits are -1e30 and the running max m
// starts at -1e30; m, the running sum l and the accumulator are float32;
// the output is acc / max(l, 1e-30), rounded once to bfloat16.  Key tiles
// wholly above the diagonal are skipped.  Sq and Skv need not be multiples
// of any tile: keys past Skv arrive as zeros and are masked, query rows past
// the end are neither read nor written.  The exponentials are
// ex2.approx.ftz with dh^-0.5 * log2(e) folded into one FMA of the logit
// (the bfloat16 tolerance holds that; the float32 kernel keeps expf).
//
// P in two parts.  P.V takes P as a bfloat16 operand.  Rounding p to one
// bfloat16 costs up to 2^-9 of each weight, which moves the outputs near 0
// past the bfloat16 check (rtol 1e-2, atol 1e-4).  So p goes in as
// hi = bf16(p) plus lo = bf16(p - hi), two products per tile, which carries
// p to within ~2^-18; l is summed from the float32 p.  That second product
// is what the check costs: 1.5x the bound's tensor-core operations.
//
// Bound.  The causal forward does 4 * dh float operations per (query row,
// visible key) pair, 7.73e10 at smollm-135m's (B, S, KV, G, dh) =
// (4, 4096, 3, 3, 64): 0.078 ms at 989 TFLOP/s on bf16 tensor cores, against
// 0.015 ms for q, k, v and o at 3.35 TB/s, so operations bound it.  With
// the hi/lo split the tensor cores do 1.5x that.  Close behind at dh 64 are
// the exponentials, one per pair (3.0e8 there, more on the tiles that
// cross the diagonal: ~0.08 ms at 16 per SM per clock), and the rest of the
// softmax: ~12 instructions per logit (max, FMA, ex2, sum, the hi/lo split,
// the O rescale), about as many issue cycles as the tensor cores need.
//
// Design.
// - Work split.  A block owns 64 * CONSUMERS consecutive (position, q head)
//   rows of one (b, kv head), so every K/V tile it loads serves all G query
//   heads; row r is position r / G, head r % G.  Each consumer warpgroup
//   owns 64 rows; there are three (two at dh 128, where O alone takes 64
//   registers a thread), beside one producer warpgroup.  The grid is
//   (B * KV, row tiles), and the row tile is taken from the end (the last
//   positions first), so the heaviest blocks of the causal triangle start
//   first and the light ones fill the tail.
// - Copies.  One thread of the producer warpgroup issues TMA loads of the K
//   and V tiles (64 keys x dh) into a ring of kStages stages, each guarded
//   by a "full" mbarrier (the copy's bytes) and an "empty" one (one arrival
//   per consumer warp).  The tensor maps view k and v as the 4-D
//   [B, Skv, KV, dh] with a box of (64-column panel or dh, 1 head, 64 keys,
//   1 batch), so keys past one batch's Skv are out of bounds (zeros), never
//   the next batch's.  Rows are 128 bytes at dh >= 64 (128-byte swizzle;
//   dh 128 as two 64-column panels) and 64 bytes at dh 32 (64-byte
//   swizzle).  Q is read once per block with 16-byte loads into the same
//   swizzled layout (a row tile is no TMA box when G does not divide it).
// - Products.  S = Q.K^T is wgmma m64n64k16 with both operands K-major in
//   shared memory.  O += P.V is wgmma m64n(dh)k16 with P from registers
//   (the S accumulator's fragment is the A fragment, as in FlashAttention-3)
//   and V MN-major in shared memory (the transpose bit set: the tile is
//   [keys][dh] with dh contiguous).  Tile t's S is issued together with
//   tile t - 1's P.V, and tile t's softmax runs while P.V is on the tensor
//   cores (FlashAttention-3's intra-warpgroup overlap).  Each step is
//   straight-line code from wgmma.fence to its last wait: the first tile is
//   peeled off and masked tiles run in a loop of their own, because ptxas
//   serialises every wgmma of a kernel that branches around one.  64-key
//   tiles keep S, O and P's two parts within the registers of the launch
//   (at most R164 of 168 at dh 128, R125 of 128 at dh 64), so nothing
//   spills; setmaxnreg still moves the producer's registers to the
//   consumers.
// - Softmax.  Each row of the accumulator fragment lives in 4 threads: the
//   row max is reduced across them with two xor shuffles; l is kept per
//   thread and reduced once at the end.
// - Epilogue.  acc / max(l, 1e-30) rounded once to bfloat16, stored through
//   the row -> (position, head) map.
// Not yet: ping-pong between the warpgroups (no gain measured while they
// overlap within themselves), a persistent grid, and a TMA store of O.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// setmaxnreg hands registers between the warpgroups of one block, so the
// block must have its SM to itself: it asks for more than half the SM's
// shared memory
constexpr int kMinSmem = 116 * 1024;
constexpr int kStages = 4;                      // K/V tiles in flight
constexpr int kBN = 64;              // keys per K/V tile: S is m64n64k16
constexpr float kNegLogit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  // consumer warpgroups of 64 (position, head) rows each, and one producer
  // warpgroup; at dh 128 the accumulator takes 64 registers a thread, so
  // two consumers (168 registers a thread at launch), else three (128)
  static constexpr int CONSUMERS = DH == 128 ? 2 : 3;
  static constexpr int ROWS = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // setmaxnreg after the split, from 65536 / THREADS at launch:
  // 128*40 + 256*232 <= 65536 and 128*24 + 384*160 <= 65536
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static constexpr int SW = DH >= 64 ? 128 : 64;    // bytes per panel row
  static constexpr int PC = SW / 2;                 // columns per panel
  static constexpr int NP = DH / PC;                // panels
  static constexpr int Q_PANEL = ROWS * SW;
  static constexpr int KV_PANEL = kBN * SW;
  static constexpr int KV_TILE = NP * KV_PANEL;     // kBN * DH * 2 bytes
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int STAGE = 2 * KV_TILE;         // K then V
  static constexpr int BARS = 2 * kStages * 8;      // full[], empty[]
  static constexpr int NEED = 1024 + Q_BYTES + kStages * STAGE + BARS;
  static constexpr int SMEM = NEED > kMinSmem ? NEED : kMinSmem;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // descriptor swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the TMA / wgmma swizzle of a byte offset from a 1024-byte aligned base:
// the 16-byte unit (bits 4..) XOR the row of the 8-row atom (bits 7..)
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
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

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous product that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one warpgroup: 64 rows x kBN keys, both operands K-major;
// q_s and k_s are the first panels of the warpgroup's Q rows and the tile
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2],
                                         uint32_t q_s, uint32_t k_s) {
  using T = Tile<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int p = kk / (T::PC / 16), kin = kk % (T::PC / 16);
    const uint64_t da = make_desc(q_s + p * T::Q_PANEL + 32 * kin, 16,
                                  8 * T::SW, T::LAYOUT);
    const uint64_t db = make_desc(k_s + p * T::KV_PANEL + 32 * kin, 16,
                                  8 * T::SW, T::LAYOUT);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// O += P V with P as hi + lo A fragments; V MN-major: key groups of 8 rows
// at 8 * SW bytes, dh panels at KV_PANEL bytes
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         const uint32_t (&hi)[kBN / 16][4],
                                         const uint32_t (&lo)[kBN / 16][4],
                                         uint32_t v_s) {
  using T = Tile<DH>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = make_desc(v_s + kk * 16 * T::SW, T::KV_PANEL,
                                  8 * T::SW, T::LAYOUT);
    wgmma_rs<DH>(acc, hi[kk], db);
    wgmma_rs<DH>(acc, lo[kk], db);
  }
}

// One tile's online-softmax step in the log2 domain, in place on the S
// fragment (logits in, p out).  Thread value 4 j + e is row grp + 8 (e / 2),
// key k0 + 8 j + 2 tq + e % 2.  EDGE tiles (crossing the diagonal or the
// end of Skv) mask first; the others fold the scale into one FMA:
// p = 2^(s * c - m), m the max of s * c (c > 0, so c * max(s)).
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c,
                                             int k0, int tq,
                                             const int (&pos)[2], int skv,
                                             int causal) {
  float mx[2] = {kNegLogit, kNegLogit};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (EDGE) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        x = key >= skv || (causal && key > pos[e >> 1]) ? kNegLogit : x * c;
        sc[4 * j + e] = x;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], EDGE ? mx[i] : mx[i] * c);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e];
      const float p = EDGE ? ex2(x - m[e >> 1]) : ex2(fmaf(x, c, -m[e >> 1]));
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// p as hi = bf16(p) plus lo = bf16(p - hi), in the A-fragment order of the
// P.V product: k-step kk takes S columns 16 kk .. 16 kk + 15, registers
// (row grp, cols 2tq..), (row grp + 8, cols 2tq..), (row grp, cols
// 2tq + 8..), (row grp + 8, cols 2tq + 8..)
__device__ __forceinline__ void split_p(const float (&sc)[kBN / 2],
                                        uint32_t (&hi)[kBN / 16][4],
                                        uint32_t (&lo)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      const __nv_bfloat162 vh = __floats2bfloat162_rn(sc[i], sc[i + 1]);
      const float2 fh = __bfloat1622float2(vh);
      hi[kk][r] = bf16x2_bits(vh);
      lo[kk][r] =
          bf16x2_bits(__floats2bfloat162_rn(sc[i] - fh.x, sc[i + 1] - fh.y));
    }
  }
}

// The producer: one thread keeps the ring of K/V tiles full.
template <int DH>
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int b, int h,
                                        int n_tiles, uint32_t kv_s,
                                        uint32_t full, uint32_t empty) {
  using T = Tile<DH>;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(full + 8 * s, T::STAGE);
    const uint32_t dst = kv_s + s * T::STAGE;
#pragma unroll
    for (int p = 0; p < T::NP; ++p) {
      tma_load_4d(dst + p * T::KV_PANEL, tm_k, p * T::PC, h, t * kBN, b,
                  full + 8 * s);
      tma_load_4d(dst + T::KV_TILE + p * T::KV_PANEL, tm_v, p * T::PC, h,
                  t * kBN, b, full + 8 * s);
    }
  }
}

// A consumer warpgroup: rows w0 .. w0 + 63 of the block's tile, its Q
// panels at q_wg.
template <int DH>
__device__ __forceinline__ void consume(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
    int sq, int skv, int kv, int g, int causal, int q_offset,
    float scale_log2, int b,
    int h, int64_t rows, int64_t w0, int n_tiles, uint32_t q_wg,
    uint32_t kv_s, uint32_t full, uint32_t empty, int bar_id) {
  using T = Tile<DH>;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, grp = lane / 4, tq = lane % 4;
  const int64_t q_head = (int64_t)b * sq * kv + h;  // [b, 0, h] in G*DH rows

  // Q rows into the swizzled K-major layout, 16 bytes a load; rows past the
  // end are zeros
  {
    constexpr int CH = DH / 8;                        // 16-byte chunks a row
    for (int e = tw; e < 64 * CH; e += 128) {
      const int r = e / CH, c = e % CH;
      const int64_t row = w0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows) {
        const int64_t pos = row / g, head = row % g;
        val = *reinterpret_cast<const uint4*>(
            q + ((q_head + pos * kv) * g + head) * DH + c * 8);
      }
      const int p = c / (T::PC / 8), cin = c % (T::PC / 8);
      const uint32_t dst =
          q_wg + p * T::Q_PANEL + swizzle<T::SW>(r * T::SW + cin * 16);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(val.x), "r"(val.y), "r"(val.z), "r"(val.w)
                   : "memory");
    }
    // visible to the tensor cores (async proxy), then to the warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
  }

  const bool live = w0 < rows;
  const int first_pos = (int)(w0 / g);
  const int last_pos = (int)(((w0 + 63 < rows ? w0 + 63 : rows - 1)) / g);
  int pos[2];                      // this thread's rows grp and grp + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = w0 + 16 * warp + grp + 8 * i;
    pos[i] = (int)((row < rows ? row : rows - 1) / g);
  }
  int qpos[2];                     // their query positions, for the mask
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q_offset + pos[i];
  // tiles this warpgroup computes (up to its last row's diagonal), and how
  // many of them come first and need no mask (below its first row's
  // diagonal and inside Skv); every diagonal is shifted by q_offset
  int n_work = live ? n_tiles : 0;
  if (live && causal && (q_offset + last_pos) / kBN + 1 < n_work)
    n_work = (q_offset + last_pos) / kBN + 1;
  const int kv_plain = causal && q_offset + first_pos + 1 < skv
                           ? q_offset + first_pos + 1
                           : skv;
  const int n_plain = kv_plain / kBN < n_work ? kv_plain / kBN : n_work;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegLogit, kNegLogit}, l[2] = {0.0f, 0.0f};
  uint32_t hi[kBN / 16][4], lo[kBN / 16][4];

  // Tile t's S = Q K^T is issued together with tile t - 1's O += P V, and
  // tile t's softmax runs while that product is on the tensor cores.  Each
  // step is straight-line code between wgmma.fence and the last wait (no
  // branch around a product), so ptxas keeps the products asynchronous.
  auto step = [&](int t, auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    const int s = t % kStages;
    const int sp = (t + kStages - 1) % kStages;      // tile t - 1's stage
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    float sc[kBN / 2];
    fence_regs(acc);
    wgmma_fence();
    issue_qk<DH>(sc, q_wg, kv_s + s * T::STAGE);
    wgmma_commit();
    issue_pv<DH>(acc, hi, lo, kv_s + sp * T::STAGE + T::KV_TILE);
    wgmma_commit();
    wgmma_wait<1>();                                  // S done, P V running
    fence_regs(sc);
    float corr[2];
    softmax_tile<EDGE>(sc, m, l, corr, scale_log2, t * kBN, tq, qpos, skv,
                       causal);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sp);       // tile t - 1 consumed
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
    }
    split_p(sc, hi, lo);
  };
  // the first tile alone: its S, its softmax (acc is still 0)
  auto first = [&](auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    mbar_wait(full, 0);
    float sc[kBN / 2];
    wgmma_fence();
    issue_qk<DH>(sc, q_wg, kv_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    softmax_tile<EDGE>(sc, m, l, corr, scale_log2, 0, tq, qpos, skv, causal);
    split_p(sc, hi, lo);
  };
  using Plain = std::integral_constant<bool, false>;
  using Edge = std::integral_constant<bool, true>;
  if (n_work > 0) {
    if (n_plain > 0) first(Plain{});
    else first(Edge{});
    for (int t = 1; t < n_plain; ++t) step(t, Plain{});
    for (int t = n_plain > 1 ? n_plain : 1; t < n_work; ++t) step(t, Edge{});
    // the last tile's P V
    const int sp = (n_work - 1) % kStages;
    fence_regs(acc);
    wgmma_fence();
    issue_pv<DH>(acc, hi, lo, kv_s + sp * T::STAGE + T::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sp);
  }
  for (int t = n_work; t < n_tiles; ++t) {          // tiles above the diagonal
    const int s = t % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: acc / max(l, 1e-30) in bfloat16 through row -> (pos, head)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = w0 + 16 * warp + grp + 8 * i;
    if (row >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const int64_t head = row % g;
    __nv_bfloat16* dst = o + ((q_head + (int64_t)pos[i] * kv) * g + head) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                acc[4 * j + 2 * i + 1] / denom);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __nv_bfloat16* __restrict__ q,
                             __nv_bfloat16* __restrict__ o, int sq, int skv,
                             int kv, int g, int causal, int q_offset,
                             float scale_log2) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;         // Q panels
  const uint32_t kv_s = q_s + T::Q_BYTES;              // stage s: K, then V
  const uint32_t full = kv_s + kStages * T::STAGE;     // full[s] at + 8 s
  const uint32_t empty = full + 8 * kStages;

  const int b = blockIdx.x / kv, h = blockIdx.x % kv;
  const int64_t rows = (int64_t)sq * g;
  // row tiles from the last positions down: the heaviest blocks start first
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * T::ROWS;
  const int64_t r_last = (r0 + T::ROWS < rows ? r0 + T::ROWS : rows) - 1;
  int kv_end = skv;
  if (causal && q_offset + (int)(r_last / g) + 1 < kv_end)
    kv_end = q_offset + (int)(r_last / g) + 1;
  const int n_tiles = (kv_end + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::PRODUCER_REGS));
    if (threadIdx.x == 128 * T::CONSUMERS)
      produce<DH>(&tm_k, &tm_v, b, h, n_tiles, kv_s, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::CONSUMER_REGS));
    consume<DH>(q, o, sq, skv, kv, g, causal, q_offset, scale_log2, b, h,
                rows, r0 + 64 * wg, n_tiles, q_s + 64 * wg * T::SW, kv_s,
                full, empty, 1 + wg);
  }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, Skv, KV, DH] bfloat16 as a 4-D map, box (panel, 1 head, kBN keys, 1)
template <int DH>
CUresult kv_map(EncodeTiled enc, CUtensorMap* map, const void* base, int b,
                int skv, int kv) {
  using T = Tile<DH>;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)kv,
                              (cuuint64_t)skv, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)kv * DH * 2,
                                 (cuuint64_t)skv * kv * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::PC, 1u, (cuuint32_t)kBN, 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int kv, int g, int causal, int q_offset,
           float scale, cudaStream_t stream) {
  using T = Tile<DH>;
  EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tk, tv;
  if (kv_map<DH>(enc, &tk, k, b, skv, kv) != CUDA_SUCCESS ||
      kv_map<DH>(enc, &tv, v, b, skv, kv) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int64_t tiles = ((int64_t)sq * g + T::ROWS - 1) / T::ROWS;
  const dim3 grid((unsigned)(b * kv), (unsigned)tiles);
  flash_attention_wgmma_kernel<DH><<<grid, T::THREADS, T::SMEM, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), sq, skv, kv, g, causal, q_offset,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the bfloat16 attention forward on `stream`: q [b, sq, kv, g, dh],
// k and v [b, skv, kv, dh], o like q, all contiguous bfloat16 with 16-byte
// aligned bases; dh in {32, 64, 128}; query row i sits at position
// q_offset + i (q_offset >= 0; causal masks key j > q_offset + i); `scale`
// multiplies the float32 logits.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for sizes
// the kernel does not take or a tensor map the driver refuses).
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, int b, int sq, int skv, int kv,
                                int g, int dh, int causal, int q_offset,
                                float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kv < 1 || g < 1 || q_offset < 0 ||
      (long long)b * kv > 2147483647LL ||
      ((long long)sq * g + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, b, sq, skv, kv, g, causal, q_offset,
                         scale, st);
    case 64:
      return launch<64>(q, k, v, o, b, sq, skv, kv, g, causal, q_offset,
                         scale, st);
    case 128:
      return launch<128>(q, k, v, o, b, sq, skv, kv, g, causal, q_offset,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
