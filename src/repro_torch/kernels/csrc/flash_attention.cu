// Causal (or full) grouped-query attention forward in float32 for NVIDIA
// Hopper (sm_90a), on the TF32 tensor cores as 3xTF32:
//   o[b, i, h, g] = sum_j softmax_j(q[b, i, h, g] . k[b, j, h] * dh^-0.5) v[b, j, h]
//   q: [B, Sq, KV, G, dh], k, v: [B, Skv, KV, dh], o like q, all float32,
//   dh in {32, 64, 128}
// over the keys j <= i + q_offset (causal: query i at position q_offset + i,
// top-left aligned at q_offset = 0) or all keys.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/flash_attention.py::flash_attention_fwd (body
//   _flash_fwd_kernel; src/repro/kernels/flash_attention.py:81)
// for float32 inputs, and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::flash_attention_ref does.  Bfloat16 inputs go
// to kernels/csrc/flash_attention_sm90.cu.
//
// 3xTF32.  One TF32 product keeps ~11 bits of each operand and leaves the
// float32 gate (rtol 2e-5 / atol 1e-5).  So every operand x goes in as
// hi = tf32(x) plus lo = tf32(x - hi) (cvt.rna), and every product as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms issued first into the
// same float32 accumulator, lo.lo dropped: ~22 bits of each product, which
// holds the gate (tests/test_torch_flash_tf32.py emulates it on the CPU).
//
// Semantics kept from the TPU kernel.  The logit is the float32 dot product
// times dh^-0.5; masked logits are -1e30; the running max m starts at
// -1e30, and m, the running sum l and the accumulator stay in float32; the
// output is acc / max(l, 1e-30).  Key tiles entirely above the diagonal are
// skipped.  Sq and Skv need not be multiples of any tile: keys past Skv are
// zeros of the split pass and masked, query rows past the end are neither
// read nor written.  Exponentials are expf (the accurate one), one per
// logit.
//
// Bound.  The causal forward does 4 * dh float operations per (query row,
// visible key) pair: 7.73e10 at smollm-135m's (B, S, KV, G, dh) =
// (4, 4096, 3, 3, 64), 0.156 ms at the tf32 tensor cores' 495 TFLOP/s on
// an H100 (1.154 ms at the CUDA cores' 67 TFLOP/s, the ceiling of an
// earlier CUDA-core version of this kernel), against ~0.03 ms for q, k, v
// and o at 3.35 TB/s.  To hold the float32 tolerance this design issues
// three TF32 products for each product (2.32e11 tensor-core operations,
// 0.469 ms at that rate), so it can reach at most a third of the bound;
// the softmax (one expf and the hi/lo split of p per logit) comes next.
//
// Design.  Two launches a call, both here.
// - The split pass (kv_split_tf32_kernel) writes K_hi, K_lo as
//   [B * KV, Skv_pad, dh] and V_hi^T, V_lo^T as [B * KV, dh, Skv_pad]
//   (keys contiguous) into the wrapper's scratch, Skv_pad = Skv rounded up
//   to kKeyPad, the pad zeros.  V goes transposed because tf32 wgmma takes
//   both shared-memory operands K-major only (the transpose bit is for
//   16-bit types).  Within each group of 8 keys the transposed rows are
//   permuted, key 2t at row t and key 2t + 1 at row t + 4: the S
//   accumulator holds columns (2t, 2t + 1) of each 8-column group where the
//   tf32 A fragment wants columns (t, t + 4), so with V's keys permuted the
//   same way P feeds the P.V product from registers unchanged (the sum over
//   the keys is the same).
// - The attention kernel (flash_attention_3xtf32_kernel) has the structure
//   of flash_attention_sm90.cu.  A block owns 64 * CONSUMERS consecutive
//   (position, q head) rows of one (b, kv head), each consumer warpgroup 64
//   of them, so every K/V tile serves all G query heads.  Row tiles go from
//   the last positions down (the heaviest causal blocks first).  One thread
//   of a producer warp issues TMA loads of the split tiles into a ring of
//   STAGES stages with separate K and V mbarriers (full: the bytes; empty:
//   one arrival per consumer warp), so a K tile loads as soon as the S
//   product STAGES tiles before it is done, and a consumer waits for V only
//   before its P.V.  Rows are 128 bytes (32 floats) with the 128-byte
//   swizzle.  Q is read once per block with 16-byte loads, split and stored
//   in the same layout (a row tile is no TMA box when G does not divide
//   it).
// - Products.  S = Q.K^T is three sets of wgmma m64nBNk8 .tf32 with both
//   operands K-major in shared memory; O += P.V three sets of
//   wgmma m64n(dh)k8 .tf32 with P's hi and lo from registers.  A
//   warpgroup's steps run in turn (S, softmax, P.V) and the two consumers'
//   products interleave on the tensor cores.  Issuing tile t's S beside
//   tile t - 1's P.V, as flash_attention_sm90.cu does, was no faster at
//   smollm's shape on an H100 (0.905-0.914 ms against 0.904-0.913, paired)
//   and spilled at dh 64 (S, P's hi and lo and O live at once).  Each
//   product is straight-line code from wgmma.fence to its wait (masked
//   tiles run in a loop of their own), because ptxas serialises every
//   wgmma of a kernel that branches around one.
// - Tiles and registers (Shape<DH> below).  P's hi and lo take a register
//   each per logit, so a consumer holds P (BN) and O (dh / 2) registers a
//   thread, 96 at dh 64 with 64-key tiles, of the 168 that ptxas gives a
//   block of two consumers and the producer warp.  Two consumers with
//   64-key tiles at dh 32 and 64; at dh 128 one consumer with 32-key tiles,
//   whose two stages and Q fit shared memory.
// - Softmax.  Each row of the accumulator fragment lives in 4 threads: the
//   row max is reduced with two xor shuffles; l is kept per thread and
//   reduced once at the end.
// Not yet: a persistent grid, ping-pong between the consumers, a TMA store
// of O, the split fused into the attention kernel.
//
// flash_attention_tile_check runs the kernel's own products on one tile
// (S = A.K^T, then O = S.V) for a first check of the fragment layouts and
// of the tensor cores' float32 accumulation against float64.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeyPad = 64;          // Skv_pad is a multiple of this
constexpr int kSplitKeys = 32;       // keys a block of the split pass takes
constexpr int kSplitThreads = 256;
constexpr float kNegLogit = -1e30f;

// consumer warpgroups (64 rows each, beside one producer warp), keys a tile
// and ring stages by head width; kernels/flash_attention.py's F32_TILES
// mirrors them
template <int DH>
struct Shape;
template <>
struct Shape<32> { static constexpr int CONSUMERS = 2, BN = 64, STAGES = 4; };
template <>
struct Shape<64> { static constexpr int CONSUMERS = 2, BN = 64, STAGES = 2; };
template <>
struct Shape<128> { static constexpr int CONSUMERS = 1, BN = 32, STAGES = 2; };

template <int DH>
struct Tile {
  static constexpr int CONSUMERS = Shape<DH>::CONSUMERS;
  static constexpr int BN = Shape<DH>::BN;
  static constexpr int STAGES = Shape<DH>::STAGES;
  static constexpr int ROWS = 64 * CONSUMERS;
  static constexpr int THREADS = 128 * CONSUMERS + 32;   // + producer warp
  static constexpr int NPD = DH / 32;               // 128-byte panels of dh
  static constexpr int NPK = BN / 32;               // 128-byte panels of keys
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int Q_BYTES = NPD * Q_PANEL;     // Q_hi, then Q_lo
  static constexpr int K_PANEL = BN * 128;
  static constexpr int K_BYTES = NPD * K_PANEL;     // K_hi, then K_lo
  static constexpr int V_PANEL = DH * 128;
  static constexpr int V_BYTES = NPK * V_PANEL;     // V_hi^T, then V_lo^T
  static constexpr int STAGE = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int BARS = 4 * STAGES * 8;       // full/empty of K and V
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE + BARS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 128-byte TMA / wgmma swizzle of a byte offset from a 1024-byte
// aligned base: the 16-byte unit (bits 4..6) XOR the row of the 8-row atom
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// K-major 128-byte-swizzled wgmma descriptor: start address, leading byte
// offset 16 (unused), stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// `x` as the compiler cannot see through: the descriptors built from it
// inside a loop are rebuilt there (a few integer adds) instead of hoisted
// out of it, where 2 x 3 x dh / 8 of them would hold registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi = tf32(x) and lo = tf32(x - hi); x - hi is exact in float32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
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

// one arrival on `bar` from lane 0 of the warp (a predicate, no branch)
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
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

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
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
// keeps the compiler from moving accesses of a register array across the
// asynchronous products that read or write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
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

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 8] * B[8 x 32], tf32, A in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] * B[8 x 64], as above
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 8] * B[8 x 128], as above
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n32(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

// one 16-byte chunk (columns 4c .. 4c + 3 of row r) into the swizzled
// K-major layout at `base`: 32-column panels `panel` bytes apart
__device__ __forceinline__ void store_chunk(uint32_t base, uint32_t panel,
                                            int r, int c, uint32_t x0,
                                            uint32_t x1, uint32_t x2,
                                            uint32_t x3) {
  const uint32_t dst =
      base + (c / 8) * panel + swizzle(r * 128 + (c % 8) * 16);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(x0), "r"(x1), "r"(x2), "r"(x3)
               : "memory");
}

// the chunk split: hi at hi_base, lo at lo_base
__device__ __forceinline__ void store_split(uint32_t hi_base, uint32_t lo_base,
                                            uint32_t panel, int r, int c,
                                            float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  store_chunk(hi_base, panel, r, c, h[0], h[1], h[2], h[3]);
  store_chunk(lo_base, panel, r, c, l[0], l[1], l[2], l[3]);
}

// S = Q K^T for one warpgroup, 64 rows x BN keys: Q_lo K_hi, Q_hi K_lo, then
// Q_hi K_hi, each dh / 8 k-steps; q_hi / q_lo are the warpgroup's first Q
// panels, k_s the stage's K_hi (K_lo follows it)
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<DH>::BN / 2],
                                         uint32_t q_hi, uint32_t q_lo,
                                         uint32_t k_s) {
  using T = Tile<DH>;
  q_hi = opaque(q_hi);
  q_lo = opaque(q_lo);
  k_s = opaque(k_s);
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    const uint32_t qa = term == 0 ? q_lo : q_hi;
    const uint32_t kb = term == 1 ? k_s + T::K_BYTES : k_s;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const int p = kk / 4, kin = kk % 4;
      wgmma_ss<T::BN>(sc, make_desc(qa + p * T::Q_PANEL + 32 * kin),
                      make_desc(kb + p * T::K_PANEL + 32 * kin),
                      term > 0 || kk > 0);
    }
  }
}

// O += P V for one warpgroup: P_lo V_hi, P_hi V_lo, then P_hi V_hi, each
// BN / 8 k-steps; v_s is the stage's V_hi^T (V_lo^T follows it)
template <int DH>
__device__ __forceinline__ void issue_pv(
    float (&acc)[DH / 2], const uint32_t (&hi)[Tile<DH>::BN / 8][4],
    const uint32_t (&lo)[Tile<DH>::BN / 8][4], uint32_t v_s) {
  using T = Tile<DH>;
  v_s = opaque(v_s);
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    const uint32_t vb = term == 1 ? v_s + T::V_BYTES : v_s;
#pragma unroll
    for (int kk = 0; kk < T::BN / 8; ++kk)
      wgmma_rs<DH>(acc, term == 0 ? lo[kk] : hi[kk],
                   make_desc(vb + (kk / 4) * T::V_PANEL + 32 * (kk % 4)));
  }
}

// One tile's online-softmax step, in place on the S fragment (logits in, p
// out).  Thread value 4 j + e is row grp + 8 (e / 2), key k0 + 8 j + 2 tq +
// e % 2.  EDGE tiles (crossing the diagonal or the end of Skv) mask.
template <bool EDGE, int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale,
                                             int k0, int tq,
                                             const int (&pos)[2], int skv,
                                             int causal) {
  float mx[2] = {kNegLogit, kNegLogit};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(sc[4 * j + e], scale);
      if (EDGE) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        if (key >= skv || (causal && key > pos[e >> 1])) x = kNegLogit;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(sc[4 * j + e] - m[e >> 1]);
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// p as tf32 hi + lo in the A-fragment order of the P.V product: k-step kk
// takes keys 8 kk .. 8 kk + 7, registers (row grp, k tq), (grp + 8, tq),
// (grp, tq + 4), (grp + 8, tq + 4); k index tq is key 2 tq and tq + 4 key
// 2 tq + 1 (V^T's rows are permuted so), i.e. S values 4 kk + {0, 2, 1, 3}
template <int BN>
__device__ __forceinline__ void split_p(const float (&sc)[BN / 2],
                                        uint32_t (&hi)[BN / 8][4],
                                        uint32_t (&lo)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split(sc[4 * kk + 0], hi[kk][0], lo[kk][0]);
    split(sc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split(sc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split(sc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// the barriers of ring stage s
struct Bars {
  uint32_t base;
  int stages;
  __device__ uint32_t full_k(int s) const { return base + 8 * s; }
  __device__ uint32_t empty_k(int s) const { return base + 8 * (stages + s); }
  __device__ uint32_t full_v(int s) const {
    return base + 8 * (2 * stages + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return base + 8 * (3 * stages + s);
  }
};

// The producer: one thread keeps the ring of split K/V tiles full, K ahead
// of V.  Tensor maps: K [2 * B * KV, Skv_pad, dh] (hi rows, then lo),
// V^T [2 * B * KV, dh, Skv_pad].
template <int DH>
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int bh,
                                        int bkv, int n_tiles, uint32_t ring,
                                        Bars bars) {
  using T = Tile<DH>;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::STAGES;
    const uint32_t parity = ((t / T::STAGES) & 1) ^ 1;
    const uint32_t dst = ring + s * T::STAGE;
    mbar_wait(bars.empty_k(s), parity);
    mbar_arrive_expect_tx(bars.full_k(s), 2 * T::K_BYTES);
#pragma unroll
    for (int p = 0; p < T::NPD; ++p) {
      tma_load_3d(dst + p * T::K_PANEL, tm_k, 32 * p, t * T::BN, bh,
                  bars.full_k(s));
      tma_load_3d(dst + T::K_BYTES + p * T::K_PANEL, tm_k, 32 * p,
                  t * T::BN, bkv + bh, bars.full_k(s));
    }
    mbar_wait(bars.empty_v(s), parity);
    mbar_arrive_expect_tx(bars.full_v(s), 2 * T::V_BYTES);
#pragma unroll
    for (int p = 0; p < T::NPK; ++p) {
      tma_load_3d(dst + 2 * T::K_BYTES + p * T::V_PANEL, tm_v,
                  t * T::BN + 32 * p, 0, bh, bars.full_v(s));
      tma_load_3d(dst + 2 * T::K_BYTES + T::V_BYTES + p * T::V_PANEL, tm_v,
                  t * T::BN + 32 * p, 0, bkv + bh, bars.full_v(s));
    }
  }
}

// A consumer warpgroup: rows w0 .. w0 + 63 of the block's tile, its Q
// panels at q_hi / q_lo.
template <int DH>
__device__ __forceinline__ void consume(
    const float* __restrict__ q, float* __restrict__ o, int sq, int skv,
    int kv, int g, int causal, int q_offset, float scale, int b, int h,
    int64_t rows,
    int64_t w0, int n_tiles, uint32_t q_hi, uint32_t q_lo, uint32_t ring,
    Bars bars, int bar_id) {
  using T = Tile<DH>;
  constexpr int BN = T::BN, ST = T::STAGES;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32, grp = lane / 4, tq = lane % 4;
  const int64_t q_head = (int64_t)b * sq * kv + h;  // [b, 0, h] in G*DH rows

  // Q rows split into the swizzled K-major layout, 16 bytes a load; rows
  // past the end are zeros
  {
    constexpr int CH = DH / 4;                        // 16-byte chunks a row
    for (int e = tw; e < 64 * CH; e += 128) {
      const int r = e / CH, c = e % CH;
      const int64_t row = w0 + r;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < rows) {
        const int64_t pos = row / g, head = row % g;
        val = *reinterpret_cast<const float4*>(
            q + ((q_head + pos * kv) * g + head) * DH + c * 4);
      }
      store_split(q_hi, q_lo, T::Q_PANEL, r, c, val);
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
  if (live && causal && (q_offset + last_pos) / BN + 1 < n_work)
    n_work = (q_offset + last_pos) / BN + 1;
  const int kv_plain = causal && q_offset + first_pos + 1 < skv
                           ? q_offset + first_pos + 1
                           : skv;
  const int n_plain = kv_plain / BN < n_work ? kv_plain / BN : n_work;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegLogit, kNegLogit}, l[2] = {0.0f, 0.0f};

  // One tile: S = Q K^T, its softmax, O = O * corr + P V.  The steps of a
  // warpgroup run in turn and the two consumers' products interleave on the
  // tensor cores; each product is straight-line code from wgmma.fence to
  // its wait (no branch around a product), so ptxas keeps them
  // asynchronous.  K(t) is released after S, V(t) waited for only before
  // P V.
  auto step = [&](int t, auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    const int s = t % ST;
    const uint32_t parity = (t / ST) & 1;
    mbar_wait(bars.full_k(s), parity);
    float sc[BN / 2];
    wgmma_fence();
    issue_qk<DH>(sc, q_hi, q_lo, ring + s * T::STAGE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive_lane0(bars.empty_k(s), lane);         // K(t) consumed
    float corr[2];
    softmax_tile<EDGE, BN>(sc, m, l, corr, scale, t * BN, tq, qpos, skv,
                           causal);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
    }
    uint32_t hi[BN / 8][4], lo[BN / 8][4];
    split_p<BN>(sc, hi, lo);
    mbar_wait(bars.full_v(s), parity);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_pv<DH>(acc, hi, lo, ring + s * T::STAGE + 2 * T::K_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_lane0(bars.empty_v(s), lane);         // V(t) consumed
  };
  using Plain = std::integral_constant<bool, false>;
  using Edge = std::integral_constant<bool, true>;
  for (int t = 0; t < n_plain; ++t) step(t, Plain{});
  for (int t = n_plain; t < n_work; ++t) step(t, Edge{});
  for (int t = n_work; t < n_tiles; ++t) {          // tiles above the diagonal
    const int s = t % ST;
    mbar_wait(bars.full_k(s), (t / ST) & 1);
    mbar_arrive_lane0(bars.empty_k(s), lane);
    mbar_wait(bars.full_v(s), (t / ST) & 1);
    mbar_arrive_lane0(bars.empty_v(s), lane);
  }

  // epilogue: acc / max(l, 1e-30) through row -> (pos, head)
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
    float* dst = o + ((q_head + (int64_t)pos[i] * kv) * g + head) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * i] / denom,
                      acc[4 * j + 2 * i + 1] / denom);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::THREADS, 1)
flash_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ q,
                              float* __restrict__ o, int sq, int skv, int kv,
                              int g, int causal, int q_offset, float scale) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;         // Q_hi, then Q_lo
  const uint32_t ring = q_s + 2 * T::Q_BYTES;          // stage s: K, then V
  const Bars bars{ring + T::STAGES * T::STAGE, T::STAGES};

  const int bh = blockIdx.x, b = bh / kv, h = bh % kv;
  const int64_t rows = (int64_t)sq * g;
  // row tiles from the last positions down: the heaviest blocks start first
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * T::ROWS;
  const int64_t r_last = (r0 + T::ROWS < rows ? r0 + T::ROWS : rows) - 1;
  int kv_end = skv;
  if (causal && q_offset + (int)(r_last / g) + 1 < kv_end)
    kv_end = q_offset + (int)(r_last / g) + 1;
  const int n_tiles = (kv_end + T::BN - 1) / T::BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bars.full_k(s), 1);
      mbar_init(bars.full_v(s), 1);
      mbar_init(bars.empty_k(s), 4 * T::CONSUMERS);
      mbar_init(bars.empty_v(s), 4 * T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    if (threadIdx.x == 128 * T::CONSUMERS)
      produce<DH>(&tm_k, &tm_v, bh, gridDim.x, n_tiles, ring, bars);
  } else {
    consume<DH>(q, o, sq, skv, kv, g, causal, q_offset, scale, b, h, rows,
                r0 + 64 * wg, n_tiles, q_s + 64 * wg * 128,
                q_s + T::Q_BYTES + 64 * wg * 128, ring, bars, 1 + wg);
  }
}

// The split pass: a block takes kSplitKeys keys of one (b, kv head), writes
// their K_hi / K_lo rows and, through shared memory, their V_hi^T / V_lo^T
// columns with the keys of each group of 8 permuted (row t <- key 2t,
// row t + 4 <- key 2t + 1).  Keys past Skv are zeros.  `split` holds K_hi,
// K_lo, V_hi^T, V_lo^T, `n` floats each.
template <int DH>
__global__ void __launch_bounds__(kSplitThreads)
kv_split_tf32_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ split_out, int skv, int kv,
                     int skv_pad, int64_t n) {
  __shared__ float vs[kSplitKeys][DH + 1];
  const int bh = blockIdx.x, b = bh / kv, h = bh % kv;
  const int t0 = blockIdx.y * kSplitKeys;
  float* k_hi = split_out + (int64_t)bh * skv_pad * DH;
  float* v_hi = split_out + 2 * n + (int64_t)bh * DH * skv_pad;
  for (int e = threadIdx.x; e < kSplitKeys * DH; e += kSplitThreads) {
    const int j = e / DH, d = e % DH, t = t0 + j;
    float kx = 0.0f, vx = 0.0f;
    if (t < skv) {
      const int64_t src = (((int64_t)b * skv + t) * kv + h) * DH + d;
      kx = k[src];
      vx = v[src];
    }
    uint32_t hi, lo;
    split(kx, hi, lo);
    k_hi[(int64_t)t * DH + d] = __uint_as_float(hi);
    k_hi[n + (int64_t)t * DH + d] = __uint_as_float(lo);
    vs[j][d] = vx;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSplitKeys * DH; e += kSplitThreads) {
    const int d = e / kSplitKeys, c = e % kSplitKeys;
    const int key = (c & ~7) | (c & 4 ? 2 * (c & 3) + 1 : 2 * (c & 3));
    uint32_t hi, lo;
    split(vs[key][d], hi, lo);
    v_hi[(int64_t)d * skv_pad + t0 + c] = __uint_as_float(hi);
    v_hi[n + (int64_t)d * skv_pad + t0 + c] = __uint_as_float(lo);
  }
}

// One warpgroup, one tile, the attention kernel's own products: S = A K^T
// (A [64, DH] split here, K the split pass's first BN keys), written as
// [64, BN]; then O = S V with S as P (split in registers), written as
// [64, DH].  Operands reach shared memory by plain loads in the TMA's
// swizzled layout.
template <int DH>
__global__ void __launch_bounds__(128)
tile_check_kernel(const float* __restrict__ a,
                  const float* __restrict__ split_in, int skv_pad, int64_t n,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  using T = Tile<DH>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + 2 * T::Q_BYTES;
  const int tw = threadIdx.x;
  const int warp = tw / 32, lane = tw % 32, grp = lane / 4, tq = lane % 4;
  for (int e = tw; e < 64 * DH / 4; e += 128) {
    const int r = e / (DH / 4), c = e % (DH / 4);
    store_split(q_s, q_s + T::Q_BYTES, T::Q_PANEL, r, c,
                *reinterpret_cast<const float4*>(a + r * DH + 4 * c));
  }
  for (int e = tw; e < BN * DH / 4; e += 128) {       // K_hi, K_lo rows
    const int r = e / (DH / 4), c = e % (DH / 4);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          split_in + part * n + r * DH + 4 * c);
      store_chunk(ring + part * T::K_BYTES, T::K_PANEL, r, c, x.x, x.y, x.z,
                  x.w);
    }
  }
  for (int e = tw; e < DH * BN / 4; e += 128) {       // V_hi^T, V_lo^T rows
    const int r = e / (BN / 4), c = e % (BN / 4);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          split_in + (2 + part) * n + (int64_t)r * skv_pad + 4 * c);
      store_chunk(ring + 2 * T::K_BYTES + part * T::V_BYTES, T::V_PANEL, r,
                  c, x.x, x.y, x.z, x.w);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float sc[BN / 2];
  wgmma_fence();
  issue_qk<DH>(sc, q_s, q_s + T::Q_BYTES, ring);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(16 * warp + grp + 8 * (e >> 1)) * BN + 8 * j + 2 * tq +
            (e & 1)] = sc[4 * j + e];
  uint32_t hi[BN / 8][4], lo[BN / 8][4];
  split_p<BN>(sc, hi, lo);
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
  issue_pv<DH>(acc, hi, lo, ring + 2 * T::K_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(16 * warp + grp + 8 * (e >> 1)) * DH + 8 * j + 2 * tq +
            (e & 1)] = acc[4 * j + e];
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

// a float32 [d2, d1, d0] array (d0 contiguous) as a 3-D map with a box of
// (32, box1, 1) and the 128-byte swizzle
CUresult map_3d(EncodeTiled enc, CUtensorMap* map, const void* base,
                uint64_t d0, uint64_t d1, uint64_t d2, uint32_t box1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {32u, box1, 1u};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int key_pad(int skv) { return (skv + kKeyPad - 1) / kKeyPad * kKeyPad; }

template <int DH>
int split_launch(const void* k, const void* v, void* scratch, int bkv,
                 int skv, int kv, cudaStream_t stream) {
  const int skv_pad = key_pad(skv);
  const int64_t n = (int64_t)bkv * skv_pad * DH;
  kv_split_tf32_kernel<DH>
      <<<dim3((unsigned)bkv, (unsigned)(skv_pad / kSplitKeys)),
         kSplitThreads, 0, stream>>>(static_cast<const float*>(k),
                                     static_cast<const float*>(v),
                                     static_cast<float*>(scratch), skv, kv,
                                     skv_pad, n);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           void* scratch, int b, int sq, int skv, int kv, int g, int causal,
           int q_offset, float scale, cudaStream_t stream) {
  using T = Tile<DH>;
  const int64_t tiles = ((int64_t)sq * g + T::ROWS - 1) / T::ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const int bkv = b * kv, skv_pad = key_pad(skv);
  const int64_t n = (int64_t)bkv * skv_pad * DH;
  CUtensorMap tk, tv;
  if (map_3d(enc, &tk, scratch, DH, skv_pad, 2ull * bkv, T::BN) !=
          CUDA_SUCCESS ||
      map_3d(enc, &tv, static_cast<float*>(scratch) + 2 * n, skv_pad, DH,
             2ull * bkv, DH) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_3xtf32_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int err = split_launch<DH>(k, v, scratch, bkv, skv, kv, stream);
  if (err != 0) return err;
  flash_attention_3xtf32_kernel<DH>
      <<<dim3((unsigned)bkv, (unsigned)tiles), T::THREADS, T::SMEM, stream>>>(
          tk, tv, static_cast<const float*>(q), static_cast<float*>(o), sq,
          skv, kv, g, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int tile_check(const void* a, const void* k, const void* v, void* scratch,
               void* s_out, void* o_out, cudaStream_t stream) {
  using T = Tile<DH>;
  constexpr int SMEM = 1024 + 2 * T::Q_BYTES + T::STAGE;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_check_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int err = split_launch<DH>(k, v, scratch, 1, kKeyPad, 1, stream);
  if (err != 0) return err;
  tile_check_kernel<DH><<<1, 128, SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(scratch),
      kKeyPad, (int64_t)kKeyPad * DH, static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the float32 attention forward on `stream`: q [b, sq, kv, g, dh],
// k and v [b, skv, kv, dh], o like q, all contiguous float32 with 16-byte
// aligned bases; `scratch` holds 4 * b * kv * Skv_pad * dh floats (Skv_pad
// = skv rounded up to a multiple of 64) for the split K/V; dh in
// {32, 64, 128}; query row i sits at position q_offset + i (q_offset >= 0;
// causal masks key j > q_offset + i); `scale` multiplies the logits.  Two
// launches: the split pass, then the attention kernel.  Returns the
// cudaError_t of the launches
// (cudaErrorInvalidValue for sizes the kernel does not take or a tensor
// map the driver refuses).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* scratch, int b, int sq, int skv,
                           int kv, int g, int dh, int causal, int q_offset,
                           float scale, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || kv < 1 || g < 1 || q_offset < 0 ||
      (long long)b * kv > 2147483647LL || skv > 2147483647 - kKeyPad ||
      key_pad(skv) / kSplitKeys > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, scratch, b, sq, skv, kv, g, causal,
                        q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, o, scratch, b, sq, skv, kv, g, causal,
                        q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, o, scratch, b, sq, skv, kv, g, causal,
                         q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's products on one tile, for a first check on a card: a
// [64, dh], k and v [64, dh] float32 (the split pass takes all 64 keys; the
// products the first BN = 64, or 32 at dh 128), `scratch` 4 * 64 * dh
// floats; writes s_out [64, BN] = a k^T and o_out [64, dh] = s_out v.
int flash_attention_tile_check(const void* a, const void* k, const void* v,
                               void* scratch, void* s_out, void* o_out,
                               int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return tile_check<32>(a, k, v, scratch, s_out, o_out, st);
    case 64:
      return tile_check<64>(a, k, v, scratch, s_out, o_out, st);
    case 128:
      return tile_check<128>(a, k, v, scratch, s_out, o_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
