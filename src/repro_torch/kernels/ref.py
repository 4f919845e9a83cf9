"""Plain PyTorch versions of the port's kernels — the port of
``repro.kernels.ref`` (``ucb_scores_ref``, ``truncnorm_times_ref``,
``bandit_round_ref``, ``local_topk_ref``, ``segmented_topk_ref``,
``fedavg_ref``, ``flash_attention_ref``, ``rg_lru_ref``), and
``threefry_ref``, the plain version of the port's own threefry kernel
(``jax.random``'s counter-based generator; no TPU kernel behind it).

They are the CPU path of ``kernels/ops.py`` and the references that the
CUDA kernels (kernels/csrc/*.cu) are held against on the card: the same
formulation, step by step.  ``segmented_topk_ref`` has no kernel: the JAX
package computes the cross-shard merge outside any Pallas kernel too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import bandit
from repro_torch.sim.truncnorm import truncnorm_transform


def ucb_scores_ref(sums: torch.Tensor, n_sel: torch.Tensor,
                   total: torch.Tensor, alpha: float = 1000.0) -> torch.Tensor:
    """Naive-UCB (Eq. 4) score of every arm: ``sums``/``n_sel`` [G, K],
    ``total`` [G] -> [G, K] float32

        -(sums / max(n, 1)) / alpha + sqrt(log max(total, 2) / (2 max(n, 1)))

    and BIG where n = 0 (explore first).  Each operation rounds to float32
    on its own; the CUDA kernel (kernels/csrc/ucb_score.cu) rounds at the
    same places."""
    nf = n_sel.float().clamp_min(1.0)
    mean = sums.float() / nf
    log_total = torch.log(total.float().clamp_min(2.0))[:, None]
    bonus = torch.sqrt(log_total / (2.0 * nf))
    score = -bandit.fdiv(mean, alpha) + bonus
    return torch.where(n_sel == 0, bandit.BIG, score)


def truncnorm_times_ref(u2, mu_theta, mu_gamma, n_samples, eta, model_bits,
                        *, fluctuate: bool = True):
    """Eqs. (8)-(11) at the candidate slice.

    ``u2``: [G, 2, C] uniforms (row 0 -> throughput theta, row 1 ->
    capability gamma); ``mu_theta``/``mu_gamma``/``n_samples``: [G, C]
    candidate-gathered means; ``eta``: [G] tensor or float.  Returns
    ([G, C] t_ud, [G, C] t_ul) with t_UD = D_k / gamma, t_UL = M / theta.
    """
    if fluctuate:
        if isinstance(eta, torch.Tensor):
            eta = eta.view(-1, 1, 1)
        drawn = truncnorm_transform(u2, torch.stack([mu_theta, mu_gamma], 1),
                                    eta)
        theta, gamma = drawn[:, 0], drawn[:, 1]
    else:
        theta, gamma = mu_theta, mu_gamma
    return (n_samples / gamma.clamp_min(1e-9),
            bandit.fdiv(model_bits, theta.clamp_min(1e-9)))


def sample_times_candidates(u2, cand_idx, n_samples, theta_mu, gamma_mu,
                            eta, model_bits, *, fluctuate: bool = True):
    """Eqs. (8)-(11) at the candidate slice: ([G, C] t_UD, [G, C] t_UL) for
    the [G, C] candidates (>= K = padding) from the [G, 2, C] uniforms
    ``u2``, the [G, K] means and the [K] dataset sizes."""
    k = theta_mu.shape[1]
    safe_c = torch.where(cand_idx < k, cand_idx, 0).long()
    return truncnorm_times_ref(u2, theta_mu.gather(1, safe_c),
                               gamma_mu.gather(1, safe_c), n_samples[safe_c],
                               eta, model_bits, fluctuate=fluctuate)


def bandit_round_ref(state, cand_idx, t_ud, t_ul, rand, hyper, *,
                     policy: str, s_round: int, decay: float = 1.0,
                     sliced: bool = False, fault: tuple | None = None,
                     deadline: float | None = None, fault_u=None):
    """One fused bandit round (score -> select -> schedule -> observe) on a
    [G]-batched :class:`~repro_torch.core.bandit.BanditState`.

    ``cand_idx``: [G, C] int32 sorted candidate indices, >= K entries
    padding.  Every policy's statistics are gathered once for the C
    candidates, Algorithm 1 / top-S runs on the [G, C] slice, and the
    winning slots map back through ``cand_idx`` (sorted candidates make the
    compacted lowest-index tie-break the lowest client index).  Returns
    ``(new_state, sel [G, S], round_time [G])``, plus ``flags`` [G, S]
    with the failure layer on (``deadline`` set; ``fault_u``: [G, 3, S]).

    ``sliced``: ``t_ud``/``t_ul``/``rand`` are candidate-aligned [G, C]
    arrays (the streamed-sampling path) instead of [G, K].
    """
    k = state.n_sel.shape[1]
    cvalid = cand_idx < k
    safe_c = torch.where(cvalid, cand_idx, 0).long()

    def gather(x):
        return x.gather(1, safe_c)

    def col(name):
        if name.startswith("hist_sum_"):
            h = getattr(state, "hist_" + name[len("hist_sum_"):])
            return bandit.row_sum(
                h.gather(1, safe_c[..., None].expand(-1, -1, h.shape[2])))
        return gather(getattr(state, name))

    def at_c(x):
        return None if x is None else (x if sliced else gather(x))

    obs = {name: col(name) for name in bandit.POLICY_STATS[policy]}
    kind, a, b = bandit.policy_scores(
        policy, obs, state.total, state.disc_total, at_c(t_ud), at_c(t_ul),
        at_c(rand), hyper)
    if kind == "score":
        slots = bandit.top_slots(a, cvalid, s_round)
    else:
        slots = bandit.greedy_slots(a, b, cvalid, s_round)
    ok = slots >= 0
    safe_slot = torch.where(ok, slots, 0).long()
    sel = torch.where(ok, cand_idx.gather(1, safe_slot), -1).to(torch.int32)

    valid = sel >= 0
    if sliced:
        sud, sul = t_ud.gather(1, safe_slot), t_ul.gather(1, safe_slot)
    else:
        safe = torch.where(valid, sel, 0).long()
        sud, sul = t_ud.gather(1, safe), t_ul.gather(1, safe)
    if deadline is None:
        round_time, incs = bandit.schedule_gathered(valid, sud, sul)
        state = bandit.observe(state, sel, sud, sul, incs, decay=decay)
        return state, sel, round_time
    round_time, incs, finish = bandit.schedule_completions(valid, sud, sul)
    obs_ud, obs_ul, obs_inc, fail, flags, round_time = bandit.censor_slots(
        valid, sud, sul, incs, finish, round_time, fault_u, fault, deadline)
    state = bandit.observe(state, sel, obs_ud, obs_ul, obs_inc, decay=decay,
                           fail=fail)
    return state, sel, round_time, flags


def bandit_round_sampled_ref(state, cand_idx, u2, rand, theta_mu, gamma_mu,
                             n_samples, eta, model_bits, hyper, *,
                             policy: str, s_round: int, decay: float = 1.0,
                             fluctuate: bool = True,
                             fault: tuple | None = None,
                             deadline: float | None = None, fault_u=None):
    """The streamed-sampling round: gather the candidates' [G, K] means,
    draw their Eq. (8) times from ``u2`` ([G, 2, C]) and run the sliced
    :func:`bandit_round_ref` — the plain version of the sampled kernel."""
    t_ud_c, t_ul_c = sample_times_candidates(
        u2, cand_idx, n_samples, theta_mu, gamma_mu, eta, model_bits,
        fluctuate=fluctuate)
    k = theta_mu.shape[1]
    rand_c = (None if rand is None else
              rand.gather(1, torch.where(cand_idx < k, cand_idx, 0).long()))
    return bandit_round_ref(
        state, cand_idx, t_ud_c, t_ul_c, rand_c, hyper, policy=policy,
        s_round=s_round, decay=decay, sliced=True, fault=fault,
        deadline=deadline, fault_u=fault_u)


def local_topk_ref(score: torch.Tensor, valid: torch.Tensor,
                   s_round: int):
    """Local top-S of each row of [..., C] ``score`` over the ``valid``
    entries: ``(vals [..., S] f32, slots [..., S] int32)`` in the order of
    :func:`~repro_torch.core.bandit.top_slots` — S masked argmax steps,
    value descending, lowest slot first on ties; an exhausted step gives
    (-inf, -1).  As there, a step whose first maximum of
    ``where(valid, score, -inf)`` falls on an invalid slot is exhausted,
    so a row whose valid scores are all -inf can end early.  The plain
    version of the ``topk_slots`` kernel (kernels/csrc/topk_slots.cu)."""
    lead = score.shape[:-1]
    flat = score.reshape(-1, score.shape[-1]).float()
    slots = bandit.top_slots(flat, valid.reshape(flat.shape), s_round)
    ok = slots >= 0
    vals = torch.where(ok, flat.gather(1, torch.where(ok, slots, 0).long()),
                       bandit.NEG_INF)
    return vals.reshape(*lead, s_round), slots.reshape(*lead, s_round)


def segmented_topk_ref(vals: torch.Tensor, slots: torch.Tensor,
                       s_round: int) -> torch.Tensor:
    """Merge P shards' local top-S into the global top-``s_round``:
    ``vals``/``slots`` [..., P, S] (slots unique candidate positions,
    -1 = exhausted) -> [..., s_round] int32 slot indices, -1 padded.

    Replays the flat masked-argmax order — value descending, lowest slot
    on exact ties — so the merge equals flat ``top_slots`` over all
    candidates: a flat pick has fewer than S better candidates in its own
    shard, hence sits inside that shard's local top-S."""
    lead = vals.shape[:-2]
    v = vals.reshape(-1, vals.shape[-2] * vals.shape[-1])
    s = slots.reshape(v.shape).to(torch.int32)
    valid = s >= 0
    imax = torch.iinfo(torch.int32).max
    slx = torch.where(valid, s, imax)
    live = valid.clone()
    out = torch.full((v.shape[0], s_round), -1, dtype=torch.int32,
                     device=v.device)
    for i in range(s_round):
        vv = torch.where(live, v, bandit.NEG_INF)
        m = vv.amax(1, keepdim=True)
        cand = live & (vv == m)
        pos = torch.where(cand, slx, imax).argmin(1, keepdim=True)
        ok = cand.gather(1, pos)
        out[:, i] = torch.where(ok, s.gather(1, pos), -1)[:, 0]
        live = live.scatter(1, pos, live.gather(1, pos) & ~ok)
    return out.reshape(*lead, s_round)


def fedavg_combine_ref(stacked: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted FedAvg combine: ``stacked`` [G, C, N] (or [C, N]) client
    rows, ``weights`` [G, C] (or [C]) -> [G, N] (or [N]).

    The rows are read in float32 and summed left to right, ``acc = x0*w0``
    then ``acc = acc + xc*wc``, each product and sum rounded on its own; the
    result is written in the input's dtype.  The CUDA kernel rounds at the
    same places, so in float32 the two agree bitwise.
    """
    x = stacked.float()
    w = weights.float()[..., None]
    acc = x[..., 0, :] * w[..., 0, :]
    for c in range(1, x.shape[-2]):
        acc = acc + x[..., c, :] * w[..., c, :]
    return acc.to(stacked.dtype)


NEG_LOGIT = -1e30          # masked logit and initial running max


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, *, window: int | None = None,
                        q_offset: int = 0, kv_valid_len: int | None = None,
                        q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """GQA attention by blocks with an online softmax: ``q`` [B, Sq, KV, G,
    dh], ``k``/``v`` [B, Skv, KV, dh] -> [B, Sq, KV, G, dh] in q's dtype.

    The plain version of the ``flash_attention`` kernel
    (kernels/csrc/flash_attention.cu) with the TPU kernel's semantics: q, k
    and v read as float32, logits ``(q . k) * dh**-0.5`` in float32, a
    top-left causal mask (query i sees keys j <= i + ``q_offset``), masked
    logits -1e30, float32 running max ``m`` (from -1e30), sum ``l`` and
    accumulator, output ``acc / max(l, 1e-30)``.  Key blocks entirely above
    the diagonal are skipped; ragged Sq and Skv are sliced, never padded.
    Memory stays at one [B, KV, G, q_block, kv_block] block of logits, so
    S = 32768 runs.  ``window``, ``q_offset`` and ``kv_valid_len`` are the
    extra masks of ``models/layers.flash_attention``, which is this
    function; the kernel takes none of them.  Skipping a fully masked block
    leaves every row that has a visible key unchanged; a row with none
    (which no caller makes) averages the values of the blocks visited.
    """
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    scale = dh ** -0.5
    dev = q.device
    kf = k.float().permute(0, 2, 1, 3)                 # [B, KV, Skv, dh]
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty_like(q)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        qb = q[:, q0:q1].float().permute(0, 2, 3, 1, 4)  # [B, KV, G, bq, dh]
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        m = torch.full(qb.shape[:-1], NEG_LOGIT, device=dev)
        l = torch.zeros(qb.shape[:-1], device=dev)
        acc = torch.zeros(qb.shape, device=dev)
        kv_end = min(skv, q_offset + q1) if causal else skv
        for k0 in range(0, kv_end, kv_block):
            k1 = min(k0 + kv_block, skv)
            s = torch.einsum("bkgqd,bktd->bkgqt", qb, kf[:, :, k0:k1]) * scale
            kv_pos = torch.arange(k0, k1, device=dev)
            mask = None
            if causal:
                mask = q_pos[:, None] >= kv_pos[None, :]
            if window is not None:
                w = q_pos[:, None] - kv_pos[None, :] < window
                mask = w if mask is None else mask & w
            if kv_valid_len is not None:
                w = (kv_pos < kv_valid_len)[None, :]
                mask = w if mask is None else mask & w
            if mask is not None:
                s = torch.where(mask, s, NEG_LOGIT)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p, vf[:, :, k0:k1])
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out


def rg_lru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The RG-LRU linear recurrence y_t = a_t * y_{t-1} + b_t, y_{-1} = 0,
    over ``a``, ``b`` [B, T, W] (any T and W) -> y [B, T, W] in a's dtype.

    The plain version of the ``rg_lru_scan`` kernel
    (kernels/csrc/rg_lru.cu): a sequential loop over T reading a and b as
    float32, with a float32 carry.  Each step rounds once,
    ``torch.addcmul(b_t, a_t, h)``, as the kernel's ``__fmaf_rn`` does and
    as XLA contracts ``a * h + b`` in the JAX package's ``rg_lru_ref``;
    ``a * h + b`` would round twice.
    """
    af, bf = a.float(), b.float()
    y = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    for t in range(a.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h, out=y[:, t])
    return y.to(a.dtype)


# ---------------------------------------------------------------------------
# threefry2x32 (kernels/csrc/threefry.cu), the generator behind jax.random
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
THREEFRY_PARITY = 0x1BD11BDA
THREEFRY_OUTS = ("bits", "pairs", "uniform")


def uint32_of(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of int32 bits, as int64."""
    return x.long() & _MASK


def int32_of(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def threefry2x32_ref(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher of 20 rounds (jax's
    ``_threefry2x32_lowering``) on uint32 values held in int64 tensors
    (broadcastable): key (k0, k1), counter (x0, x1) -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


@functools.cache
def uniform_affine(minval: float, maxval: float) -> tuple[float, float]:
    """(lo, span) of ``jax.random.uniform``'s bounds in float32: the
    bounds rounded to float32 and their float32 difference."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(maxval) - lo)


def threefry_ref(keys: torch.Tensor, n: int, *, offset: int = 0,
                 row_offsets: torch.Tensor | None = None, out: str = "bits",
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Threefry-2x32 of N keys over n counters: the plain version of the
    ``threefry`` kernel.

    ``keys``: [N, 2] int32 (the uint32 key words).  Row i hashes the 64-bit
    counters c = offset + row_offsets[i] + j for j < n, as (hi, lo) =
    (c >> 32, c mod 2^32) — jax's ``iota_2x32_shape`` of a flat index, so
    counters [offset, offset + n) are that slice of a draw of any larger
    size.  ``out``:

      * "bits": [N, n] int32, the 32-bit draw y0 ^ y1
        (``_threefry_random_bits_partitionable``);
      * "pairs": [N, n, 2] int32, (y0, y1) — ``split``'s keys and
        ``fold_in``'s key;
      * "uniform": [N, n] float32, ``jax.random.uniform``'s float on
        [minval, maxval): the bits' top 23 as the mantissa of [1, 2), minus
        1, times the float32 span plus minval rounded once (XLA:CPU
        contracts jax's ``floats * (maxval - minval) + minval`` into one
        FMA; ``torch.addcmul`` rounds it once too), then at least minval.
    """
    if out not in THREEFRY_OUTS:
        raise ValueError(f"out must be one of {THREEFRY_OUTS}, got {out!r}")
    dev = keys.device
    k = uint32_of(keys.reshape(-1, 2))
    c = offset + torch.arange(n, dtype=torch.int64, device=dev)[None]
    if row_offsets is not None:
        c = c + row_offsets.reshape(-1, 1).long()
    y0, y1 = threefry2x32_ref(k[:, :1], k[:, 1:], (c >> 32) & _MASK,
                              c & _MASK)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    if out == "pairs":
        return int32_of(torch.stack([y0, y1], -1))
    bits = y0 ^ y1
    if out == "bits":
        return int32_of(bits)
    lo, span = uniform_affine(minval, maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.addcmul(torch.full_like(f, lo), f,
                         torch.full_like(f, span)).clamp_min(lo)
