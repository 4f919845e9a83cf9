// Local top-S of the segmented (client-sharded) selection, for NVIDIA
// Hopper (sm_90a): for every row of a [R, C] score matrix (R = G grid
// points x P shards), S masked argmax steps over the row's valid entries.
//
// Replaces the TPU kernel of the JAX package
//   repro/kernels/bandit_round.py::topk_slots_pallas  (_topk_slots_kernel)
// and computes what the plain PyTorch version
// repro_torch/kernels/ref.py::local_topk_ref does: step i takes the first
// maximum x of e = where(live, score, -inf) over the whole row (live =
// valid and not yet picked; NaN ranks above every number, equal values go
// to the lower index) and gives (score[x], x) if x is live, else
// (-inf, -1).  Only comparisons happen, so the result equals the plain
// version bitwise.
//
// The same result in one pass.  Let L be the live entries whose score is
// not -inf (NaN included).  While L has an unpicked entry the first maximum
// lies in L, so the first min(S, |L|) steps give the head of L in the
// argmax order.  Once L is spent every e_j is -inf and the first maximum is
// entry 0: it is live only if it is valid with score -inf (an entry of L
// has been picked, an invalid one never lives), and then the step gives
// (-inf, 0) once; every later step gives (-inf, -1).  So a split row needs
// only the head of L across its chunks, and entry 0 for the tail.
//
// Keys.  Each entry becomes an order-preserving uint32 key: 0 outside L
// (invalid, or -inf), 0xffffffff for NaN, else the float's bits mapped so
// that a larger float has a larger key (-0.0 as +0.0, as the comparison
// ranks them).  An argmax is then the largest key and, among equal keys,
// the lowest index: two redux.sync per warp.  A picked entry's key becomes
// 0, so a step never needs the validity bytes again.
//
// Design.  The Pallas kernel holds the [C] row in VMEM and runs S argmax
// passes over it.  Here a row is split over a thread-block cluster of B
// blocks and each block takes one contiguous chunk.  The caller's plan
// (kernels/topk_slots.py::plan) picks B to give the card about two blocks
// an SM (up to 16, the non-portable cluster size; B = 1 up to C = 8191) and
// the block's threads from the chunk, holding a split launch small enough
// that all its clusters fit the card at once; the launch checks only what
// guards memory.
//   stage  every thread loads its entries (j = tid + n * T, sixteen loads
//          in flight, coalesced) once from global memory, writes their keys
//          to shared memory and keeps its own first maximum: the leaves of
//          a tournament tree (one best per thread's "group" of entries),
//          whose next level holds one best per warp of groups.  Then every
//          warp but one leaves.
//   select one warp per block, with no block barrier; lane w keeps warp w's
//          node in a register, so the block's best is one warp reduction.
//          In a cluster, lane m posts it into block m's inbox by an
//          asynchronous remote store (st.async) that completes its 8 bytes
//          on block m's mbarrier; each block waits on its own barrier and
//          reduces the B posts, so all blocks agree on the pick (and on
//          when L is spent) after one hop between SMs a step, with no
//          cluster barrier.  Inboxes and barriers are double-buffered by
//          step parity.  The block holding the pick zeroes its key,
//          rescans that group (its entries one per lane) and refreshes the
//          group's two tree nodes.  Block 0 writes the picks 32 at a time,
//          one lane each, so the load of a pick's score is not waited for
//          in every step.
//   stream a chunk whose keys outgrow the block's shared memory keeps the
//          first `staged` keys there and reads the rest from global memory
//          at each rescan, with a bitmap of its picks: one group a step,
//          ceil(chunk / T) entries (62 at C = 10^6), by one warp.
// One launch per call; a cluster of one block is the same code.
//
// Bound.  The least the card must move is each score (4 B) and validity
// byte once and the S outputs: 2.4 us at (R, C) = (16, 10^5), under a
// launch.  The kernel reads each byte once; what remains is latency: the
// staging loads, then S dependent steps, each six warp reductions and
// three shared-memory round trips (about 0.4 us on an H100) and, in a
// cluster, one hop between SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 16;         // loads in flight per thread when staging
constexpr int kMaxCluster = 16;     // blocks a row is split over, at most
// dynamic shared memory a block takes at most (keys and bitmap): the
// block's 227 KB less 9 KB for the static tree nodes below
constexpr int kSmemBudget = 232448 - 9216;

struct __align__(8) Best {
  unsigned key, idx;                // idx: entry of the row (UINT_MAX: none)
};

__device__ __forceinline__ unsigned key_of(float v, uint8_t valid) {
  if (!valid || v == -INFINITY) return 0u;
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the warp's best: the largest key, then the lowest index holding it
__device__ __forceinline__ Best warp_best(Best b) {
  const unsigned k = __reduce_max_sync(0xffffffffu, b.key);
  const unsigned i = __reduce_min_sync(0xffffffffu,
                                       b.key == k ? b.idx : UINT_MAX);
  return Best{k, i};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// address of this block's shared `addr` in the shared memory of cluster
// block `rank`
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this step's arrival on `bar`: `bytes` of posts are to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// post `b` (8 bytes) into a cluster block's inbox slot by an asynchronous
// remote store that completes its bytes on that block's barrier
__device__ __forceinline__ void post_to(uint32_t slot, uint32_t bar, Best b) {
  const uint64_t w = (uint64_t)b.key << 32 | b.idx;
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(slot),
      "l"(w), "r"(bar)
      : "memory");
}

// waits for the phase of `bar` with this parity to complete; a wait of
// 2^34 clocks (over 8 s) traps, so a fault ends the launch with an error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
topk_slots_kernel(const float* __restrict__ score,
                  const uint8_t* __restrict__ valid, float* __restrict__ vals,
                  int32_t* __restrict__ slots, int c, int s, int chunk,
                  int staged, int words) {
  extern __shared__ unsigned smem[];
  unsigned* const picked = smem;            // the streamed entries' picks
  unsigned* const keys = smem + words;      // the staged entries' keys
  __shared__ Best group_best[kMaxThreads];  // tree leaves: one per thread
  __shared__ Best warp_node[32];            // one per 32 groups
  __shared__ uint64_t inbox[2][kMaxCluster];  // every block's post, by step
  __shared__ uint64_t arrived[2];             // the posts' barriers, by step

  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;   // nt: a power of two
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t row = blockIdx.x / nb;
  const int c0 = rank * chunk;
  const int len = min(chunk, c - c0);       // > 0, checked at launch
  const float* const sc = score + row * c + c0;
  const uint8_t* const va = valid + row * c + c0;
  const Best none{0u, UINT_MAX};

  // every barrier is initialised before any block may post to it; the
  // cluster barrier's arrive here and its wait after the staging hide its
  // latency
  if (tid < 2) mbar_init(smem_u32(&arrived[tid]), 1);
  if (nb > 1) {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  for (int w = tid; w < words; w += nt) picked[w] = 0u;

  // stage this thread's group, entries tid + n * nt, kUnroll loads at once;
  // thread 0 of block 0 also learns whether entry 0 is a live -inf
  Best mine = none;
  bool live_inf0 = false;
  for (int j = tid; j < len; j += kUnroll * nt) {
    float sv[kUnroll];
    uint8_t vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = j + u * nt;
      sv[u] = l < len ? sc[l] : 0.0f;
      vv[u] = l < len ? va[l] : 0;
    }
    if (c0 + j == 0) live_inf0 = vv[0] && sv[0] == -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = j + u * nt;
      const unsigned k = key_of(sv[u], vv[u]);
      if (l < staged) keys[l] = k;
      if (k > mine.key) mine = Best{k, (unsigned)(c0 + l)};
    }
  }
  group_best[tid] = mine;
  const Best w0 = warp_best(mine);
  if (lane == 0) warp_node[warp] = w0;
  __syncthreads();                     // the tree is built
  if (nb > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp != 0) return;               // one warp a block selects

  const bool out = rank == 0;
  // lane m < nb posts to block m: its inbox slot for this block, its barrier
  const int to = lane < nb ? lane : 0;
  const uint32_t slot = remote(smem_u32(&inbox[0][rank]), to);
  const uint32_t bar = remote(smem_u32(&arrived[0]), to);
  Best node = lane < nwarps ? warp_node[lane] : none;   // lane w: warp w's
  unsigned held = UINT_MAX;            // lane m holds picks m, m + 32, ..
  int i = 0;
  for (; i < s; ++i) {
    Best b = warp_best(node);
    if (nb > 1) {
      const int buf = i & 1;
      if (lane == 0) mbar_expect(smem_u32(&arrived[buf]), nb * 8);
      if (lane < nb) post_to(slot + buf * kMaxCluster * 8, bar + buf * 8, b);
      mbar_wait(smem_u32(&arrived[buf]), (i >> 1) & 1);
      if (lane < nb) {
        const uint64_t w = inbox[buf][lane];
        b = Best{(unsigned)(w >> 32), (unsigned)w};
      }
      b = warp_best(lane < nb ? b : none);
    }
    if (b.key == 0u) break;              // L is spent: the same in every block
    if (lane == (i & 31)) held = b.idx;
    if ((i & 31) == 31) {                // write the last 32 picks at once
      if (out) {
        vals[row * s + i - 31 + lane] = score[row * c + held];
        slots[row * s + i - 31 + lane] = (int32_t)held;
      }
      held = UINT_MAX;
    }
    const int l = (int)b.idx - c0;
    if (l < 0 || l >= len) continue;     // another block's pick
    if (lane == 0) {
      if (l < staged) {
        keys[l] = 0u;
      } else {
        const int q = l - staged;
        picked[q >> 5] |= 1u << (q & 31);
      }
    }
    __syncwarp();
    // rescan the pick's group g: entries g + n * nt, n = lane, lane + 32..
    const int g = l & (nt - 1);
    Best r = none;
    for (int e = g + lane * nt; e < len; e += 32 * nt) {
      unsigned k;
      if (e < staged) {
        k = keys[e];
      } else {
        const int q = e - staged;
        k = (picked[q >> 5] >> (q & 31)) & 1u ? 0u : key_of(sc[e], va[e]);
      }
      if (k > r.key) r = Best{k, (unsigned)(c0 + e)};
    }
    r = warp_best(r);
    if (lane == 0) group_best[g] = r;
    __syncwarp();
    r = warp_best(group_best[(g & ~31) + lane]);
    if (lane == g >> 5) node = r;
  }
  if (!out) return;
  // the picks not yet written, then the tail: entry 0 once if it is a live
  // -inf, then (-inf, -1)
  const int done = i & ~31;
  if (held != UINT_MAX) {
    vals[row * s + done + lane] = score[row * c + held];
    slots[row * s + done + lane] = (int32_t)held;
  }
  const bool zero = __shfl_sync(0xffffffffu, live_inf0, 0);
  for (int j = i + lane; j < s; j += 32) {
    vals[row * s + j] = -INFINITY;
    slots[row * s + j] = zero && j == i ? 0 : -1;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: score [rows, c] float32, valid [rows, c] bytes (0/1),
// vals [rows, s] float32, slots [rows, s] int32, all contiguous; each row
// split over `cluster` blocks of `threads` threads, `chunk` entries a block,
// of which `staged` keys in shared memory and the rest streamed with a
// bitmap of `words` words.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan that would leave a block without entries
// or overrun shared memory).
int topk_slots_launch(const float* score, const uint8_t* valid, float* vals,
                      int32_t* slots, long long rows, int c, int s,
                      int cluster, int chunk, int staged, int words,
                      int threads, void* stream) {
  const long long smem = 4ll * words + 4ll * staged;
  if (rows < 1 || c < 1 || s < 1 || cluster < 1 || cluster > kMaxCluster ||
      chunk < 1 || (long long)(cluster - 1) * chunk >= c ||
      (long long)cluster * chunk < c || threads < 32 ||
      threads > kMaxThreads || (threads & (threads - 1)) || staged < 0 ||
      staged > chunk || words < 0 || 32ll * words < chunk - staged ||
      smem > kSmemBudget || rows * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the kernel's attributes, once per device
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !((ready >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(topk_slots_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          topk_slots_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
          1);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_slots_kernel, score, valid, vals, slots,
                           c, s, chunk, staged, words);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
