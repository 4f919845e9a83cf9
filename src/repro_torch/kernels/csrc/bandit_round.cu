// One fused bandit round (score -> select -> schedule -> observe) for a
// [G] grid of independent runs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package
//   repro/kernels/bandit_round.py::bandit_round_pallas          (SAMPLED=false)
//   repro/kernels/bandit_round.py::bandit_round_pallas_sampled  (SAMPLED=true)
// whose shared body is _round_body.  It computes what the plain PyTorch
// version repro_torch/kernels/ref.py::bandit_round_ref does, step by step.
//
// Design.  The Pallas kernel keeps the whole [K] state resident in VMEM.
// Here one thread block serves one grid point g, and only the C sorted
// candidates are brought on chip.  The block has the fewest multiple of 32
// threads that covers C, up to 1024:
//   gather   the threads stride over the candidates (two at a time when C
//            exceeds the block) and read only the statistics the policy
//            needs (ring-buffer rows reduced over W), issuing every load of
//            a batch before using any; the policy's two estimates (padded
//            against bank conflicts; NaN marks a padding candidate) and the
//            two resource times go to shared memory, ~16.25 B a candidate.
//            The sampled variant draws the Eq. (8) times here from the
//            caller's uniforms (t_UD = D_k / gamma, t_UL = M / theta).
//   select   S steps of an argmax by the first ~C / 4 threads (fewer
//            warps issue less a step): thread tid owns slots tid * PER + j,
//            j < PER (PER a power of two from 4 to 16), with an
//            availability bit each and their estimates in its registers
//            when PER = 4, else read from shared memory.  A candidate's
//            value (the score, or -T_inc from the running (t, t_d) clock
//            for Algorithm 1) is mapped to an order-preserving uint32 key
//            (select_key).  A warp takes its max key with one redux.sync
//            and the first lane holding it with a ballot: slots run in
//            thread, lane and warp order, so that is the lowest slot.  Each
//            warp writes its winner to a double-buffered shared slot; after
//            the step's one barrier (a named one, of the selecting threads)
//            every warp reduces the <= 32 winners the same way and updates
//            its own copy of the clock and of the winner's availability.
//            NaN is never taken; an exhausted mask yields -1.
//   schedule the picks' client indices and times are read in parallel (the
//            fault draws were loaded before the gather), then one thread
//            runs the realized-schedule and T_inc recursions and the
//            failure layer (deadline censoring and per-slot flags) on
//            shared memory.
//   observe  updates in place only the S selected rows (and their ring-slot
//            write); discounted UCB first decays all K disc_* entries of the
//            row with a strided pass (float4s where the rows allow).
// Every float operation is an explicitly rounded intrinsic (__fadd_rn, ...),
// so nvcc cannot contract a*b+c into an FMA: the kernel rounds where the
// plain version rounds, e.g. disc = round(round(x * gamma) + obs).
//
// Bound.  The round is latency-bound: S dependent argmax steps, each a
// pass over a thread's PER slots, a warp reduction, one barrier and another
// reduction; and the dependent global loads of the
// gather (candidate index, then its row).  It moves C * (stats + times)
// bytes in, S rows of state in and out, and for discounted UCB 3 * K * 8
// bytes for the decay pass; at the sweep's shapes that is microseconds of
// memory traffic against S barrier-separated steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxS = 256;          // largest s_round the kernel takes
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 16;         // candidate slots of a thread
constexpr int kRegPer = 4;          // at most this many in its registers
// Largest C the kernel takes, as the first version's layout of 17 B a
// candidate in the block's 232,448 B less 8 KB allowed; this one needs
// about 16.25 B a candidate.
constexpr int kMaxC = 13191;
constexpr float kBig = 1e12f;       // cold-arm exploration sentinel
static_assert(kMaxC <= kMaxPer * kMaxThreads && kMaxPer <= 32,
              "candidate slots of a thread must fit its availability bits");
static_assert((2 * (kMaxC + (kMaxC >> 5) + 1) + 2 * kMaxC) * 4 <=
                  232448 - 8192,
              "the largest C must fit the block's shared memory");

enum Policy {
  FEDCS = 0, EXTENDED_FEDCS = 1, NAIVE_UCB = 2, ELEMENTWISE_UCB = 3,
  RANDOM = 4, ORACLE = 5, DISCOUNTED_UCB = 6, SLIDING_UCB = 7
};

}  // namespace

// Field order and types must match kernels/bandit_round.py::_RoundArgs.
struct RoundArgs {
  // bandit state, updated in place: [G, K] / [G, K, W] / [G]
  int32_t* n_sel; float* sum_ud; float* sum_ul; float* sum_tinc;
  int32_t* total; float* last_ud; float* last_ul;
  float* hist_ud; float* hist_ul; int32_t* hist_n;
  float* disc_n; float* disc_ud; float* disc_ul; float* disc_total;
  int32_t* n_fail;
  // round inputs
  const int32_t* cand;      // [G, C] sorted, >= K = padding
  const float* t_ud;        // [G, K] (legacy variant)
  const float* t_ul;        // [G, K]
  const float* u2;          // [G, 2, C] (sampled variant)
  const float* theta_mu;    // [G, K]
  const float* gamma_mu;    // [G, K]
  const float* n_samples;   // [K]
  const float* eta;         // [G]
  const float* rand;        // [G, K] or null
  const float* fault_u;     // [G, 3, S] or null
  // outputs
  int32_t* sel;             // [G, S]
  float* round_time;        // [G]
  int32_t* flags;           // [G, S]
  // sizes and switches
  int32_t g, k, c, w, s, policy, fluctuate, failure, has_fault;
  // scalars
  float hyper, decay, model_bits, deadline, p_crash, p_churn, p_corrupt;
  float p_lo, p_span, sqrt2;
  float erfinv_lt5[9];      // Giles' erfinv coefficients, Horner order
  float erfinv_ge5[9];
};

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// repro_torch/sim/truncnorm.py::erfinv
__device__ float erfinv_f32(const RoundArgs& a, float x) {
  float w = -log1pf(mul(-x, x));
  bool lt = w < 5.0f;
  float ww = lt ? sub(w, 2.5f) : sub(sqrtf(w), 3.0f);
  float p = lt ? a.erfinv_lt5[0] : a.erfinv_ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    p = add(lt ? a.erfinv_lt5[i] : a.erfinv_ge5[i], mul(p, ww));
  }
  return fabsf(x) == 1.0f ? mul(x, INFINITY) : mul(p, x);
}

// repro_torch/sim/truncnorm.py::truncnorm_transform
__device__ float truncnorm(const RoundArgs& a, float u, float mean, float eta) {
  float sigma = sqrtf(powf(fmaxf(mean, 1e-12f), eta));
  float p = add(a.p_lo, mul(u, a.p_span));
  float z = mul(a.sqrt2, erfinv_f32(a, sub(mul(2.0f, p), 1.0f)));
  float out = add(mean, mul(sigma, z));
  float lo = fmaxf(sub(mean, sigma), 1e-9f);
  return fminf(fmaxf(out, lo), add(mean, sigma));
}

// UCB bonus sqrt(ln SigmaN / 2 N_k), BIG for never-selected arms
__device__ __forceinline__ float ucb_bonus(int n, float log_total) {
  return n == 0 ? kBig
                : sqrtf(dvd(log_total, mul(2.0f, fmaxf((float)n, 1.0f))));
}

// Algorithm 1: T_inc of an arm with estimates (ud, ul) given the clock
__device__ __forceinline__ float t_inc(float ud, float ul, float t, float td) {
  float ntd = fmaxf(td, ul);
  return add(add(sub(ntd, td), fmaxf(sub(ud, sub(t, td)), 0.0f)), ul);
}

// Order-preserving uint32 image of an argmax value: a larger float has a
// larger key, -0.0 and +0.0 share one key, -inf has the smallest nonzero
// key and NaN has key 0, the key of "no candidate", so it is never taken.
// With the lowest slot first among equal keys this is the order of
// better(v, i, bv, bi) = v > bv || (v == bv && i < bi) from (-inf, none).
// tests/test_torch_kernel_layout.py emulates it.
__device__ __forceinline__ unsigned select_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0.0 -> +0.0
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? 0u : k;
}

// shared-memory index of slot c's estimates: one word of padding every 32
// keeps reads of slots tid * PER + j free of bank conflicts
__device__ __forceinline__ int padded(int c) { return c + (c >> 5); }

// Estimates and times of the candidates in slots c0 + i * nt, i < CH, into
// shared memory; a padding candidate's first estimate is NaN, which is
// never selected.  A warp issues its loads in two waves (candidate
// indices, then every statistic and mean of the batch's rows) before it
// uses any, as it stalls at the first use of a pending load.
template <bool SAMPLED, int CH>
__device__ __forceinline__ void gather(const RoundArgs& a, int c0, int nt,
                                       int g, float log_total,
                                       float log_dtotal, float* est_a,
                                       float* est_b, float* tud, float* tul) {
  const int C = a.c, K = a.k, W = a.w;
  const size_t row0 = (size_t)g * K;
  const float hyper = a.hyper;
  int slot[CH], kk[CH];
  bool ok[CH];
  size_t r[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    slot[i] = c0 + i * nt;
    const int q = slot[i] < C ? a.cand[(size_t)g * C + slot[i]] : K;
    ok[i] = q < K;
    kk[i] = ok[i] ? q : 0;
    r[i] = row0 + kk[i];
  }
  // the policy's statistics of each row (n: a count; f0..f2: sums, ring
  // heads or the random draw)
  int n[CH], hn[CH];
  float f0[CH], f1[CH], f2[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    n[i] = hn[i] = 0;
    f0[i] = f1[i] = f2[i] = 0.0f;
    switch (a.policy) {
      case FEDCS:
        f0[i] = a.last_ud[r[i]];
        f1[i] = a.last_ul[r[i]];
        break;
      case EXTENDED_FEDCS:
        hn[i] = a.hist_n[r[i]];
        f0[i] = a.hist_ud[r[i] * W];
        f1[i] = a.hist_ul[r[i] * W];
        break;
      case NAIVE_UCB:
        n[i] = a.n_sel[r[i]];
        f0[i] = a.sum_tinc[r[i]];
        break;
      case ELEMENTWISE_UCB:
        n[i] = a.n_sel[r[i]];
        f0[i] = a.sum_ud[r[i]];
        f1[i] = a.sum_ul[r[i]];
        break;
      case RANDOM:
        f0[i] = a.rand[r[i]];
        break;
      case DISCOUNTED_UCB:
        f0[i] = a.disc_n[r[i]];
        f1[i] = a.disc_ud[r[i]];
        f2[i] = a.disc_ul[r[i]];
        break;
      case SLIDING_UCB:
        hn[i] = a.hist_n[r[i]];
        n[i] = a.n_sel[r[i]];
        f0[i] = a.hist_ud[r[i] * W];
        f1[i] = a.hist_ul[r[i] * W];
        break;
      default:
        break;
    }
  }
  float tu[CH], tl[CH];
  if (SAMPLED) {
    float theta[CH], gamma[CH], ns[CH], u0[CH], u1[CH];
    const bool fl = a.fluctuate;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      theta[i] = a.theta_mu[r[i]];
      gamma[i] = a.gamma_mu[r[i]];
      ns[i] = a.n_samples[kk[i]];
      const bool in = fl && slot[i] < C;
      u0[i] = in ? a.u2[((size_t)g * 2 + 0) * C + slot[i]] : 0.5f;
      u1[i] = in ? a.u2[((size_t)g * 2 + 1) * C + slot[i]] : 0.5f;
    }
    if (fl) {
      const float eta = a.eta[g];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        theta[i] = truncnorm(a, u0[i], theta[i], eta);
        gamma[i] = truncnorm(a, u1[i], gamma[i], eta);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      tu[i] = dvd(ns[i], fmaxf(gamma[i], 1e-9f));
      tl[i] = dvd(a.model_bits, fmaxf(theta[i], 1e-9f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      tu[i] = a.t_ud[r[i]];
      tl[i] = a.t_ul[r[i]];
    }
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (slot[i] < C) {
      tud[slot[i]] = tu[i];
      tul[slot[i]] = tl[i];
    }
  }

  // ring-buffer sums h[0] + h[1] + ... + h[W-1] (h[0] is loaded above)
  if (a.policy == EXTENDED_FEDCS || a.policy == SLIDING_UCB) {
    for (int j = 1; j < W; ++j) {
      float hu[CH], hl[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        hu[i] = a.hist_ud[r[i] * W + j];
        hl[i] = a.hist_ul[r[i] * W + j];
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        f0[i] = add(f0[i], hu[i]);
        f1[i] = add(f1[i], hl[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    float x = 0.0f, y = 0.0f;
    switch (a.policy) {
      case FEDCS:
        x = f0[i];
        y = f1[i];
        break;
      case EXTENDED_FEDCS: {
        const float nh = (float)max(hn[i], 1);
        x = dvd(f0[i], nh);
        y = dvd(f1[i], nh);
        break;
      }
      case NAIVE_UCB: {
        const float mean = dvd(f0[i], fmaxf((float)n[i], 1.0f));
        x = add(dvd(-mean, hyper), ucb_bonus(n[i], log_total));
        break;
      }
      case ELEMENTWISE_UCB: {
        const float nf = fmaxf((float)n[i], 1.0f);
        const float bo = ucb_bonus(n[i], log_total);
        x = sub(dvd(dvd(f0[i], nf), hyper), bo);
        y = sub(dvd(dvd(f1[i], nf), hyper), bo);
        break;
      }
      case RANDOM:
        x = f0[i];
        break;
      case ORACLE:
        x = tu[i];
        y = tl[i];
        break;
      case DISCOUNTED_UCB: {
        const float dn = f0[i];
        const bool cold = dn < 0.01f;
        const float ns = fmaxf(dn, 1e-3f);
        const float mu = cold ? 0.0f : dvd(f1[i], ns);
        const float ml = cold ? 0.0f : dvd(f2[i], ns);
        const float b = sqrtf(dvd(log_dtotal, mul(2.0f, ns)));
        const float bo = cold ? kBig : fminf(b, kBig);
        x = sub(dvd(mu, hyper), bo);
        y = sub(dvd(ml, hyper), bo);
        break;
      }
      case SLIDING_UCB: {
        const float nh = (float)max(hn[i], 1);
        const float bo = ucb_bonus(n[i], log_total);
        x = sub(dvd(dvd(f0[i], nh), hyper), bo);
        y = sub(dvd(dvd(f1[i], nh), hyper), bo);
        break;
      }
    }
    if (slot[i] < C) {
      est_a[padded(slot[i])] = ok[i] ? x : NAN;
      est_b[padded(slot[i])] = y;
    }
  }
}

// one warp's winner of a selection step
struct __align__(16) Best {
  unsigned key;
  int slot;
  float ea, eb;
};

template <bool SAMPLED, int PER>
__global__ void __launch_bounds__(kMaxThreads)
bandit_round_kernel(const RoundArgs a) {
  extern __shared__ float smem[];
  const int C = a.c, K = a.k, W = a.w, S = a.s;
  const int cp = padded(C) + 1;
  float* est_a = smem;                 // Algorithm-1 t_UD estimate | score
  float* est_b = smem + cp;            // Algorithm-1 t_UL estimate
  float* tud = smem + 2 * cp;          // this round's true times
  float* tul = smem + 2 * cp + C;

  __shared__ Best best[2][32];         // per warp, double-buffered
  __shared__ int pick[kMaxS];          // selected candidate slot, -1 = none
  __shared__ int client[kMaxS];
  __shared__ float obs_ud[kMaxS], obs_ul[kMaxS], obs_inc[kMaxS];
  __shared__ unsigned char fault_bits[kMaxS], failed[kMaxS];
  __shared__ int n_valid;

  constexpr int LOG_PER = PER == 4 ? 2 : PER == 8 ? 3 : 4;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)g * K;
  const bool greedy = a.policy != NAIVE_UCB && a.policy != RANDOM;
  const bool faults = a.failure && a.has_fault;
  const float* fu = a.fault_u + (size_t)g * 3 * S;
  // this thread's slot's fault draws, loaded now and used after the gather
  // (2 is above every probability: no fault)
  float fu_crash = 2.0f, fu_churn = 2.0f, fu_corrupt = 2.0f;
  if (faults && tid < S) {
    fu_crash = fu[tid];
    fu_churn = fu[S + tid];
    fu_corrupt = fu[2 * S + tid];
  }
  const float log_total = logf(fmaxf((float)a.total[g], 2.0f));
  const float log_dtotal = logf(fmaxf(a.disc_total[g], 2.0f));

  // ---- gather: every thread, candidates c, c + nt, ... ------------------
  if (C > nt) {                        // two candidates in flight a thread
    for (int c0 = tid; c0 < C; c0 += 2 * nt)
      gather<SAMPLED, 2>(a, c0, nt, g, log_total, log_dtotal, est_a, est_b,
                         tud, tul);
  } else if (tid < C) {
    gather<SAMPLED, 1>(a, tid, nt, g, log_total, log_dtotal, est_a, est_b,
                       tud, tul);
  }
  for (int i = tid; i < S; i += nt) {
    if (i != tid) {
      fu_crash = faults ? fu[i] : 2.0f;
      fu_churn = faults ? fu[S + i] : 2.0f;
      fu_corrupt = faults ? fu[2 * S + i] : 2.0f;
    }
    fault_bits[i] = (fu_crash < a.p_crash) | (fu_churn < a.p_churn) << 1 |
                    (fu_corrupt < a.p_corrupt) << 2;
  }
  __syncthreads();

  // ---- select: S block-wide argmax steps, one barrier each -------------
  // Only the first nsel threads select (fewer warps, less to issue a
  // step); thread tid owns slots tid * PER + j, j < PER, and keeps their
  // estimates in registers when there are at most kRegPer of them.  Slots
  // run in thread, then lane, then warp order, so the lowest slot among
  // equal keys is a thread's first j, a warp's first lane and the first
  // warp that holds the largest key.
  const int nsel = min(nt, ((C + PER - 1) / PER + 31) / 32 * 32);
  constexpr bool REG = PER <= kRegPer;
  float td_true = 0.0f;                // thread 0: latest true upload time
  if (tid < nsel) {
    const int nwarps = nsel >> 5;
    const int p0 = padded(tid * PER);  // slots never cross a padding word
    float ea[REG ? PER : 1], eb[REG ? PER : 1];
    unsigned avail = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool in = tid * PER + j < C;
      const float x = in ? est_a[p0 + j] : NAN;
      if (x == x) avail |= 1u << j;
      if (REG) {
        ea[j] = x;
        eb[j] = in ? est_b[p0 + j] : 0.0f;
      }
    }
    // the S steps, with the policy's kind fixed for the compiler
    auto steps = [&](auto greedy_kind) {
      constexpr bool GREEDY = decltype(greedy_kind)::value;
      float t = 0.0f, td = 0.0f;       // Algorithm 1's clock, every thread
      for (int i = 0; i < S; ++i) {
        // this thread's first largest value (NaN never; a -inf is taken
        // over nothing, as its key is above "no candidate")
        float bv = 0.0f, ba = 0.0f, bb = 0.0f;
        int bj = -1;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (REG || (avail & (1u << j))) {
            const float x = REG ? ea[REG ? j : 0] : est_a[p0 + j];
            const float y = REG ? eb[REG ? j : 0] : est_b[p0 + j];
            const float v = GREEDY ? -t_inc(x, y, t, td) : x;
            const bool take = (avail & (1u << j)) &&
                              (bj < 0 ? v == v : v > bv);
            bv = take ? v : bv;
            bj = take ? j : bj;
            ba = take ? x : ba;
            bb = take ? y : bb;
          }
        }
        const unsigned bk = bj < 0 ? 0u : select_key(bv);
        const unsigned wk = __reduce_max_sync(0xffffffffu, bk);
        const unsigned lanes = __ballot_sync(0xffffffffu, bk == wk);
        const int buf = i & 1;
        if (lane == __ffs(lanes) - 1) {
          best[buf][warp] = Best{wk, tid * PER + bj, ba, bb};
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(nsel) : "memory");
        const Best e =
            lane < nwarps ? best[buf][lane] : Best{0u, 0, 0.0f, 0.0f};
        const unsigned mk = __reduce_max_sync(0xffffffffu, e.key);
        int ms = -1;
        if (mk != 0) {
          const int src = __ffs(__ballot_sync(0xffffffffu, e.key == mk)) - 1;
          ms = __shfl_sync(0xffffffffu, e.slot, src);
          if (GREEDY) {
            const float wa = __shfl_sync(0xffffffffu, e.ea, src);
            const float wb = __shfl_sync(0xffffffffu, e.eb, src);
            const float tn = fmaxf(add(t, t_inc(wa, wb, t, td)), 0.0f);
            td = fmaxf(td, wb);
            t = tn;
          }
          if ((ms >> LOG_PER) == tid) avail &= ~(1u << (ms & (PER - 1)));
          if (tid == 0) td_true = fmaxf(td_true, tul[ms]);
        }
        if (tid == 0) pick[i] = ms;
      }
    };
    if (greedy) {
      steps(std::true_type{});
    } else {
      steps(std::false_type{});
    }
  }
  __syncthreads();
  // the picks' client indices and true times, in parallel
  for (int i = tid; i < S; i += nt) {
    const int p = pick[i];
    client[i] = p >= 0 ? a.cand[(size_t)g * C + p] : -1;
    obs_ud[i] = p >= 0 ? tud[p] : 0.0f;
    obs_ul[i] = p >= 0 ? tul[p] : 0.0f;
  }
  __syncthreads();

  // ---- schedule + failure layer: one thread runs the recursions -------
  if (tid == 0) {
    float tc = td_true;           // realized clock
    float it = 0.0f, itd = 0.0f;  // T_inc recursion clock
    bool any_fail = false;
    int nv = 0;
    const float dl = a.deadline;
    for (int i = 0; i < S; ++i) {
      const bool valid = client[i] >= 0;
      const float ud = obs_ud[i], ul = obs_ul[i];
      const float t2 = add(fmaxf(tc, add(td_true, ud)), ul);
      if (valid) tc = t2;
      const float ntd = fmaxf(itd, ul);
      const float inc = add(add(sub(ntd, itd), fmaxf(sub(ud, sub(it, itd)), 0.0f)), ul);
      if (valid) {
        it = add(it, inc);
        itd = ntd;
      }
      obs_inc[i] = valid ? inc : 0.0f;
      failed[i] = 0;
      int flag = valid ? 0 : -1;
      if (a.failure) {
        const bool crash = fault_bits[i] & 1, churn = fault_bits[i] & 2;
        const bool corrupt = fault_bits[i] & 4;
        const bool missed = tc > dl;  // slot's completion offset
        const bool fail = valid && (crash || churn || missed);
        if (valid) {
          flag = crash ? 1 : churn ? 2 : missed ? 3 : corrupt ? 4 : 0;
        }
        if (fail) {
          obs_ud[i] = dl;
          obs_ul[i] = dl;
          obs_inc[i] = dl;
          failed[i] = 1;
          any_fail = true;
        }
      }
      nv += valid;
      a.sel[(size_t)g * S + i] = client[i];
      a.flags[(size_t)g * S + i] = flag;
    }
    a.round_time[g] = any_fail ? dl : tc;
    n_valid = nv;
  }
  __syncthreads();

  // ---- observe: decay pass, then the selected rows ----------------------
  const bool decays = a.decay != 1.0f;
  if (decays) {
    const float d = a.decay;
    constexpr int U = 2;             // float4s in flight per thread and array
    const bool vec = (K & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(a.disc_n) |
                       reinterpret_cast<uintptr_t>(a.disc_ud) |
                       reinterpret_cast<uintptr_t>(a.disc_ul)) & 15) == 0;
    if (vec) {                       // rows start on 16 bytes: float4s
      float4* pn = reinterpret_cast<float4*>(a.disc_n + row0);
      float4* pu = reinterpret_cast<float4*>(a.disc_ud + row0);
      float4* pl = reinterpret_cast<float4*>(a.disc_ul + row0);
      const int k4 = K >> 2;
      for (int j0 = tid; j0 < k4; j0 += U * nt) {
        float4 vn[U], vu[U], vl[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * nt;
          if (j < k4) {
            vn[u] = pn[j];
            vu[u] = pu[j];
            vl[u] = pl[j];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * nt;
          if (j < k4) {
            pn[j] = make_float4(mul(vn[u].x, d), mul(vn[u].y, d),
                                mul(vn[u].z, d), mul(vn[u].w, d));
            pu[j] = make_float4(mul(vu[u].x, d), mul(vu[u].y, d),
                                mul(vu[u].z, d), mul(vu[u].w, d));
            pl[j] = make_float4(mul(vl[u].x, d), mul(vl[u].y, d),
                                mul(vl[u].z, d), mul(vl[u].w, d));
          }
        }
      }
    } else {
      constexpr int V = 4 * U;       // as many floats in flight
      for (int j0 = tid; j0 < K; j0 += V * nt) {
        float dn[V], du[V], dv[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int j = j0 + u * nt;
          if (j < K) {
            dn[u] = a.disc_n[row0 + j];
            du[u] = a.disc_ud[row0 + j];
            dv[u] = a.disc_ul[row0 + j];
          }
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int j = j0 + u * nt;
          if (j < K) {
            a.disc_n[row0 + j] = mul(dn[u], d);
            a.disc_ud[row0 + j] = mul(du[u], d);
            a.disc_ul[row0 + j] = mul(dv[u], d);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < S; i += nt) {
    if (client[i] < 0) continue;
    const size_t r = row0 + client[i];
    // every load first: the rows of distinct state fields never alias
    const int n_old = a.n_sel[r], hn = a.hist_n[r];
    const float su = a.sum_ud[r], sl = a.sum_ul[r], st = a.sum_tinc[r];
    float dn = 0.0f, du = 0.0f, dv = 0.0f;
    if (decays) {
      dn = a.disc_n[r];
      du = a.disc_ud[r];
      dv = a.disc_ul[r];
    }
    const int nf = failed[i] ? a.n_fail[r] : 0;
    const size_t h = r * W + n_old % W;
    a.n_sel[r] = n_old + 1;
    a.sum_ud[r] = add(su, obs_ud[i]);
    a.sum_ul[r] = add(sl, obs_ul[i]);
    a.sum_tinc[r] = add(st, obs_inc[i]);
    a.last_ud[r] = obs_ud[i];
    a.last_ul[r] = obs_ul[i];
    a.hist_ud[h] = obs_ud[i];
    a.hist_ul[h] = obs_ul[i];
    a.hist_n[r] = min(hn + 1, W);
    if (decays) {
      a.disc_n[r] = add(dn, 1.0f);
      a.disc_ud[r] = add(du, obs_ud[i]);
      a.disc_ul[r] = add(dv, obs_ul[i]);
    }
    if (failed[i]) a.n_fail[r] = nf + 1;
  }
  if (tid == 0) {
    a.total[g] += n_valid;
    if (decays) {
      a.disc_total[g] = add(mul(a.disc_total[g], a.decay), (float)n_valid);
    }
  }
}

size_t smem_bytes(int c) {
  return (size_t)(2 * (c + (c >> 5) + 1) + 2 * c) * sizeof(float);
}

// threads: a multiple of 32 covering C, up to 1024; per: the slots a
// selecting thread owns, a power of two, at least kRegPer and enough for
// C within 1024 threads
void block_shape(int c, int* threads, int* per) {
  int t = (c + 31) / 32 * 32;
  t = t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
  int p = kRegPer;
  while (p * kMaxThreads < c) p *= 2;
  *threads = t;
  *per = p;
}

template <bool SAMPLED, int PER>
int launch_per(const RoundArgs& a, int threads, cudaStream_t stream) {
  static bool ready[64] = {};          // the smem limit, raised once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(bandit_round_kernel<SAMPLED, PER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxC));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  bandit_round_kernel<SAMPLED, PER>
      <<<a.g, threads, smem_bytes(a.c), stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool SAMPLED>
int launch(const RoundArgs& a, cudaStream_t stream) {
  int threads, per;
  block_shape(a.c, &threads, &per);
  switch (per) {
    case 4: return launch_per<SAMPLED, 4>(a, threads, stream);
    case 8: return launch_per<SAMPLED, 8>(a, threads, stream);
    case 16: return launch_per<SAMPLED, 16>(a, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch one round on `stream`; returns the cudaError_t of the launch.
int bandit_round_launch(const RoundArgs* args, int sampled, void* stream) {
  if (args->s > kMaxS || args->c < 0 || args->c > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sampled ? launch<true>(*args, st) : launch<false>(*args, st);
}

int bandit_round_max_c() { return kMaxC; }

int bandit_round_max_s() { return kMaxS; }

int bandit_round_args_size() { return (int)sizeof(RoundArgs); }

}  // extern "C"
