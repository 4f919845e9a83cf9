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
// candidates are brought on chip:
//   gather   the block's threads stride over the candidates, read only the
//            statistics the policy needs (ring-buffer rows reduced over W)
//            and keep the policy's per-candidate estimates and the two
//            resource times in dynamic shared memory (17 B per candidate).
//            The sampled variant draws the Eq. (8) times here from the
//            caller's uniforms (t_UD = D_k / gamma, t_UL = M / theta).
//   select   S steps of a block-wide argmax (warp shuffles, then shared
//            memory); the lowest candidate slot wins ties and an exhausted
//            mask yields -1.  Algorithm 1 recomputes each candidate's T_inc
//            from the running (t, t_d) clock at every step.
//   schedule one thread runs the realized-schedule and T_inc recursions and
//            the failure layer (deadline censoring and per-slot flags).
//   observe  updates in place only the S selected rows (and their ring-slot
//            write); discounted UCB first decays all K disc_* entries of the
//            row with a strided pass.
// Every float operation is an explicitly rounded intrinsic (__fadd_rn, ...),
// so nvcc cannot contract a*b+c into an FMA: the kernel rounds where the
// plain version rounds, e.g. disc = round(round(x * gamma) + obs).
//
// Bound.  The round is latency-bound: S dependent block-wide reductions,
// each a few shared-memory passes over C and two barriers.  It moves
// C * (stats + times) bytes in, S rows of state in and out, and for
// discounted UCB 3 * K * 8 bytes for the decay pass; at the sweep's shapes
// that is microseconds of memory traffic against S barrier-separated steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxS = 256;          // largest s_round the kernel takes
constexpr int kMaxThreads = 1024;
constexpr float kBig = 1e12f;       // cold-arm exploration sentinel

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

__device__ __forceinline__ float ring_sum(const float* h, int w) {
  float s = h[0];
  for (int j = 1; j < w; ++j) s = add(s, h[j]);
  return s;
}

// Algorithm 1: T_inc of an arm with estimates (ud, ul) given the clock
__device__ __forceinline__ float t_inc(float ud, float ul, float t, float td) {
  float ntd = fmaxf(td, ul);
  return add(add(sub(ntd, td), fmaxf(sub(ud, sub(t, td)), 0.0f)), ul);
}

// (value, index) order of the argmax: larger value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool SAMPLED>
__global__ void bandit_round_kernel(const RoundArgs a) {
  extern __shared__ float smem[];
  const int C = a.c, K = a.k, W = a.w, S = a.s;
  float* est_a = smem;                 // Algorithm-1 t_UD estimate | score
  float* est_b = smem + C;             // Algorithm-1 t_UL estimate
  float* tud = smem + 2 * C;           // this round's true times
  float* tul = smem + 3 * C;
  unsigned char* avail = reinterpret_cast<unsigned char*>(smem + 4 * C);

  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int pick[kMaxS];          // selected candidate slot, -1 = none
  __shared__ int client[kMaxS];
  __shared__ float obs_ud[kMaxS], obs_ul[kMaxS], obs_inc[kMaxS];
  __shared__ unsigned char failed[kMaxS];
  __shared__ float clk_t, clk_td;
  __shared__ int n_valid;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthreads + 31) >> 5;
  const size_t row0 = (size_t)g * K;
  const bool greedy = a.policy != NAIVE_UCB && a.policy != RANDOM;
  const float hyper = a.hyper;
  const float log_total = logf(fmaxf((float)a.total[g], 2.0f));
  const float log_dtotal = logf(fmaxf(a.disc_total[g], 2.0f));

  // ---- gather: per-candidate estimates and times into shared memory ----
  for (int c = tid; c < C; c += nthreads) {
    const int kk = a.cand[(size_t)g * C + c];
    const bool ok = kk < K;
    const size_t r = row0 + (ok ? kk : 0);
    float tu, tl;
    if (SAMPLED) {
      float theta = a.theta_mu[r], gamma = a.gamma_mu[r];
      if (a.fluctuate) {
        const float eta = a.eta[g];
        theta = truncnorm(a, a.u2[((size_t)g * 2 + 0) * C + c], theta, eta);
        gamma = truncnorm(a, a.u2[((size_t)g * 2 + 1) * C + c], gamma, eta);
      }
      tu = dvd(a.n_samples[ok ? kk : 0], fmaxf(gamma, 1e-9f));
      tl = dvd(a.model_bits, fmaxf(theta, 1e-9f));
    } else {
      tu = a.t_ud[r];
      tl = a.t_ul[r];
    }
    float ea = 0.0f, eb = 0.0f;
    switch (a.policy) {
      case FEDCS:
        ea = a.last_ud[r];
        eb = a.last_ul[r];
        break;
      case EXTENDED_FEDCS: {
        const float n = (float)max(a.hist_n[r], 1);
        ea = dvd(ring_sum(a.hist_ud + r * W, W), n);
        eb = dvd(ring_sum(a.hist_ul + r * W, W), n);
        break;
      }
      case NAIVE_UCB: {
        const int n = a.n_sel[r];
        const float mean = dvd(a.sum_tinc[r], fmaxf((float)n, 1.0f));
        ea = add(dvd(-mean, hyper), ucb_bonus(n, log_total));
        break;
      }
      case ELEMENTWISE_UCB: {
        const int n = a.n_sel[r];
        const float nf = fmaxf((float)n, 1.0f), bo = ucb_bonus(n, log_total);
        ea = sub(dvd(dvd(a.sum_ud[r], nf), hyper), bo);
        eb = sub(dvd(dvd(a.sum_ul[r], nf), hyper), bo);
        break;
      }
      case RANDOM:
        ea = a.rand[r];
        break;
      case ORACLE:
        ea = tu;
        eb = tl;
        break;
      case DISCOUNTED_UCB: {
        const float n = a.disc_n[r];
        const bool cold = n < 0.01f;
        const float ns = fmaxf(n, 1e-3f);
        const float mu = cold ? 0.0f : dvd(a.disc_ud[r], ns);
        const float ml = cold ? 0.0f : dvd(a.disc_ul[r], ns);
        const float b = sqrtf(dvd(log_dtotal, mul(2.0f, ns)));
        const float bo = cold ? kBig : fminf(b, kBig);
        ea = sub(dvd(mu, hyper), bo);
        eb = sub(dvd(ml, hyper), bo);
        break;
      }
      case SLIDING_UCB: {
        const float n = (float)max(a.hist_n[r], 1);
        const float bo = ucb_bonus(a.n_sel[r], log_total);
        ea = sub(dvd(dvd(ring_sum(a.hist_ud + r * W, W), n), hyper), bo);
        eb = sub(dvd(dvd(ring_sum(a.hist_ul + r * W, W), n), hyper), bo);
        break;
      }
    }
    est_a[c] = ea;
    est_b[c] = eb;
    tud[c] = tu;
    tul[c] = tl;
    avail[c] = ok;
  }
  if (tid == 0) {
    clk_t = 0.0f;
    clk_td = 0.0f;
  }
  __syncthreads();

  // ---- select: S block-wide argmax steps ---------------------------------
  for (int i = 0; i < S; ++i) {
    const float t = clk_t, td = clk_td;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = tid; c < C; c += nthreads) {
      if (!avail[c]) continue;
      const float v = greedy ? -t_inc(est_a[c], est_b[c], t, td) : est_a[c];
      if (v > bv) {               // strict: this thread's lowest index wins
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const bool ok = bi != INT_MAX;
        pick[i] = ok ? bi : -1;
        if (ok) {
          avail[bi] = 0;
          if (greedy) {
            clk_t = fmaxf(add(t, t_inc(est_a[bi], est_b[bi], t, td)), 0.0f);
            clk_td = fmaxf(td, est_b[bi]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- schedule + failure layer (one thread) -----------------------------
  if (tid == 0) {
    float td_true = 0.0f;
    int nv = 0;
    for (int i = 0; i < S; ++i) {
      if (pick[i] >= 0) td_true = fmaxf(td_true, tul[pick[i]]);
    }
    float t = td_true;            // realized clock
    float it = 0.0f, itd = 0.0f;  // T_inc recursion clock
    bool any_fail = false;
    const float dl = a.deadline;
    for (int i = 0; i < S; ++i) {
      const int p = pick[i];
      const bool valid = p >= 0;
      const float ud = valid ? tud[p] : 0.0f, ul = valid ? tul[p] : 0.0f;
      const float t2 = add(fmaxf(t, add(td_true, ud)), ul);
      if (valid) t = t2;
      const float ntd = fmaxf(itd, ul);
      const float inc = add(add(sub(ntd, itd), fmaxf(sub(ud, sub(it, itd)), 0.0f)), ul);
      if (valid) {
        it = add(it, inc);
        itd = ntd;
      }
      client[i] = valid ? a.cand[(size_t)g * C + p] : -1;
      obs_ud[i] = ud;
      obs_ul[i] = ul;
      obs_inc[i] = valid ? inc : 0.0f;
      failed[i] = 0;
      int flag = valid ? 0 : -1;
      if (a.failure) {
        bool crash = false, churn = false, corrupt = false;
        if (a.has_fault) {
          const float* fu = a.fault_u + (size_t)g * 3 * S;
          crash = fu[i] < a.p_crash;
          churn = fu[S + i] < a.p_churn;
          corrupt = fu[2 * S + i] < a.p_corrupt;
        }
        const bool missed = t > dl;   // slot's completion offset
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
    a.round_time[g] = any_fail ? dl : t;
    n_valid = nv;
  }
  __syncthreads();

  // ---- observe: decay pass, then the selected rows ----------------------
  const bool decays = a.decay != 1.0f;
  if (decays) {
    for (int j = tid; j < K; j += nthreads) {
      a.disc_n[row0 + j] = mul(a.disc_n[row0 + j], a.decay);
      a.disc_ud[row0 + j] = mul(a.disc_ud[row0 + j], a.decay);
      a.disc_ul[row0 + j] = mul(a.disc_ul[row0 + j], a.decay);
    }
    __syncthreads();
  }
  for (int i = tid; i < S; i += nthreads) {
    if (client[i] < 0) continue;
    const size_t r = row0 + client[i];
    const int n_old = a.n_sel[r];
    const size_t h = r * W + n_old % W;
    a.n_sel[r] = n_old + 1;
    a.sum_ud[r] = add(a.sum_ud[r], obs_ud[i]);
    a.sum_ul[r] = add(a.sum_ul[r], obs_ul[i]);
    a.sum_tinc[r] = add(a.sum_tinc[r], obs_inc[i]);
    a.last_ud[r] = obs_ud[i];
    a.last_ul[r] = obs_ul[i];
    a.hist_ud[h] = obs_ud[i];
    a.hist_ul[h] = obs_ul[i];
    a.hist_n[r] = min(a.hist_n[r] + 1, W);
    if (decays) {
      a.disc_n[r] = add(a.disc_n[r], 1.0f);
      a.disc_ud[r] = add(a.disc_ud[r], obs_ud[i]);
      a.disc_ul[r] = add(a.disc_ul[r], obs_ul[i]);
    }
    if (failed[i]) a.n_fail[r] += 1;
  }
  if (tid == 0) {
    a.total[g] += n_valid;
    if (decays) {
      a.disc_total[g] = add(mul(a.disc_total[g], a.decay), (float)n_valid);
    }
  }
}

size_t smem_bytes(int c) {
  return (size_t)c * 4 * sizeof(float) + (size_t)c;
}

template <bool SAMPLED>
int launch(const RoundArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.c);
  cudaError_t err = cudaFuncSetAttribute(
      bandit_round_kernel<SAMPLED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((a.c + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  bandit_round_kernel<SAMPLED><<<a.g, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one round on `stream`; returns the cudaError_t of the launch.
int bandit_round_launch(const RoundArgs* args, int sampled, void* stream) {
  if (args->s > kMaxS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sampled ? launch<true>(*args, st) : launch<false>(*args, st);
}

size_t bandit_round_smem_bytes(int c) { return smem_bytes(c); }

int bandit_round_max_s() { return kMaxS; }

int bandit_round_args_size() { return (int)sizeof(RoundArgs); }

}  // extern "C"
