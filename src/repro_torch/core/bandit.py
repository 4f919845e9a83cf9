"""PyTorch port of ``repro.core.bandit_jax`` — the flat, single-device parts.

The bandit state and every step of one protocol round — policy scoring,
Algorithm 1 / top-S selection, the realized upload schedule, the
failure layer and the ``observe`` update — as plain functions on tensors.
The JAX package ``vmap``s them over the (eta x seed) grid; here every state
leaf and every per-round input carries an explicit leading ``[G]`` grid
axis instead, and the functions are written for it.

Randomness is never drawn here: the round functions take their random
inputs (the random policy's uniforms ``rand``, the fault uniforms
``fault_u``) as tensors, so tests can hand both packages the same numbers.

Counterparts (JAX package -> here): ``BanditState``, ``ucb_bonus_arrays``,
``observe``, ``greedy_slots``, ``top_slots``, ``schedule_selected`` /
``schedule_gathered`` / ``schedule_completions``, ``FLAG_*``,
``resolve_fault``, ``censor_slots``, ``POLICY_STATS``, ``policy_kind``,
``policy_scores``, ``policy_decay``, ``DEFAULT_HYPERS``,
``scatter_cand_times``, ``round_via_mask``, ``make_round_fn``,
``make_sampled_round_fn``.  Not ported yet: the client-sharded segmented
round, the hierarchical cell bandit and the index-based ``select_*`` API.
Not ported: ``FUSED_MIN_K``, the JAX package's CPU-timed small-K routing
to the unfused pipeline; a fused round here always takes the fused path.
"""

from __future__ import annotations

import dataclasses
import functools
import operator

import numpy as np
import torch

BIG = 1e12

DEFAULT_ALPHA = 1000.0
DEFAULT_BETA = 50.0
DEFAULT_GAMMA = 0.99    # discounted-UCB decay
HIST_WINDOW = 5         # Extended-FedCS moving-average window (paper: 5)

NEG_INF = float("-inf")


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float — the value a
    weakly typed Python scalar takes in a float32 JAX expression."""
    return float(np.float32(x))


@dataclasses.dataclass
class BanditState:
    """Per-client bandit statistics for a [G] grid of independent runs.

    Leaves are [G, K] (per client), [G, K, W] (ring buffers) or [G]
    (scalar counters).  The ``disc_*`` fields are the gamma-decayed twin of
    the running sums; ``n_fail`` counts censored observations.
    """

    n_sel: torch.Tensor      # [G, K] int32
    sum_ud: torch.Tensor     # [G, K] f32
    sum_ul: torch.Tensor     # [G, K] f32
    sum_tinc: torch.Tensor   # [G, K] f32
    total: torch.Tensor      # [G] int32
    last_ud: torch.Tensor    # [G, K] f32  (FedCS; 0 = never selected)
    last_ul: torch.Tensor    # [G, K] f32
    hist_ud: torch.Tensor    # [G, K, W] f32 ring buffers (Extended FedCS)
    hist_ul: torch.Tensor    # [G, K, W] f32
    hist_n: torch.Tensor     # [G, K] int32 valid ring-buffer entries
    disc_n: torch.Tensor     # [G, K] f32 gamma-discounted selection count
    disc_ud: torch.Tensor    # [G, K] f32
    disc_ul: torch.Tensor    # [G, K] f32
    disc_total: torch.Tensor  # [G] f32 gamma-discounted Sigma N_k
    n_fail: torch.Tensor     # [G, K] int32 censored observations

    @staticmethod
    def create(g: int, k: int, window: int = HIST_WINDOW,
               device="cpu") -> "BanditState":
        """Fresh all-zeros state: ``g`` runs of ``k`` clients."""
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        i32 = torch.int32
        return BanditState(
            n_sel=z(g, k, dtype=i32), sum_ud=z(g, k), sum_ul=z(g, k),
            sum_tinc=z(g, k), total=z(g, dtype=i32), last_ud=z(g, k),
            last_ul=z(g, k), hist_ud=z(g, k, window), hist_ul=z(g, k, window),
            hist_n=z(g, k, dtype=i32), disc_n=z(g, k), disc_ud=z(g, k),
            disc_ul=z(g, k), disc_total=z(g), n_fail=z(g, k, dtype=i32))

    def replace(self, **kw) -> "BanditState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "BanditState":
        return BanditState(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(BanditState))


def ucb_bonus_arrays(n_sel: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """UCB exploration bonus sqrt(ln SigmaN / 2 N_k) on [G, *] per-arm counts
    and [G] totals; BIG for never-selected clients (explore first)."""
    nf = n_sel.float().clamp_min(1.0)
    log_total = torch.log(total.float().clamp_min(2.0))
    bonus = torch.sqrt(log_total.view(-1, *([1] * (nf.dim() - 1)))
                       / (2.0 * nf))
    return torch.where(n_sel == 0, BIG, bonus)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx)


def observe(state: BanditState, idx: torch.Tensor, t_ud: torch.Tensor,
            t_ul: torch.Tensor, tinc: torch.Tensor, decay: float = 1.0,
            fail: torch.Tensor | None = None) -> BanditState:
    """Batch reward update for the selected clients (``idx``: [G, S]).

    Entries with ``idx < 0`` (the -1 padding of an exhausted selection) are
    no-ops.  ``decay`` (a Python float, see :func:`policy_decay`) multiplies
    the ``disc_*`` statistics before this round's observations are added;
    at exactly 1.0 they are left alone, as nothing reads them.  ``fail``
    ([G, S] bool) marks censored observations, counted in ``n_fail``.
    Returns a new state; ``state`` is not modified.

    Selected clients are distinct within a row, so every update is a
    scatter-add in which the padding slots add exactly zero to client 0.
    """
    g, k = state.n_sel.shape
    w = state.hist_ud.shape[2]
    idx = idx.long()
    valid = (idx >= 0) & (idx < k)
    safe = torch.where(valid, idx, 0)
    n_valid = valid.sum(1, dtype=torch.int32)

    def add(x, v):
        return x.scatter_add(1, safe, torch.where(valid, v, 0).to(x.dtype))

    hit = add(torch.zeros_like(state.n_sel), torch.ones_like(safe)) > 0

    def put(x, v):
        return torch.where(hit, add(torch.zeros_like(x), v), x)

    # ring-buffer write at slot n_sel % W of each selected client, as one
    # scatter over the flattened [G, K*W] buffer
    slot = _gather(state.n_sel, idx.clamp(0, k - 1)).long() % w
    flat = safe * w + slot
    hit_h = torch.zeros((g, k * w), dtype=torch.int32,
                        device=idx.device).scatter_add(
        1, flat, valid.int()) > 0

    def put_hist(h, v):
        h = h.reshape(g, k * w)
        new = h.new_zeros(h.shape).scatter_add(1, flat,
                                               torch.where(valid, v, 0))
        return torch.where(hit_h, new, h).reshape(g, k, w)

    disc = {}
    if float(decay) != 1.0:
        disc = dict(
            disc_n=add(state.disc_n * decay, torch.ones_like(t_ud)),
            disc_ud=add(state.disc_ud * decay, t_ud),
            disc_ul=add(state.disc_ul * decay, t_ul),
            disc_total=state.disc_total * decay + n_valid.float())
    if fail is not None:
        disc["n_fail"] = add(state.n_fail, (valid & fail).int())
    return state.replace(
        n_sel=add(state.n_sel, torch.ones_like(safe)),
        sum_ud=add(state.sum_ud, t_ud),
        sum_ul=add(state.sum_ul, t_ul),
        sum_tinc=add(state.sum_tinc, tinc),
        total=state.total + n_valid,
        last_ud=put(state.last_ud, t_ud),
        last_ul=put(state.last_ul, t_ul),
        hist_ud=put_hist(state.hist_ud, t_ud),
        hist_ul=put_hist(state.hist_ul, t_ul),
        hist_n=(state.hist_n + hit.int()).clamp_max(w),
        **disc)


def greedy_slots(est_ud: torch.Tensor, est_ul: torch.Tensor,
                 valid: torch.Tensor, s_round: int) -> torch.Tensor:
    """Algorithm 1 on [G, N] per-arm estimates (N = K with a candidate mask,
    or C on a candidate-compacted slice).  Returns [G, s_round] int32 picks,
    -1 padded.

    Each step picks the arm with the smallest T_inc (Eq. 1) given the
    running schedule clock; ties go to the lowest index (``argmax`` returns
    the first maximum).  The elapsed accumulator is clamped at 0 so the BIG
    exploration sentinel cannot poison later comparisons.
    """
    g = est_ud.shape[0]
    mask = valid.clone()
    t = est_ud.new_zeros(g, 1)
    t_d = est_ud.new_zeros(g, 1)
    sel = torch.full((g, s_round), -1, dtype=torch.int32,
                     device=est_ud.device)
    for i in range(s_round):
        new_t_d = torch.maximum(t_d, est_ul)
        tinc = (new_t_d - t_d) + torch.clamp_min(est_ud - (t - t_d), 0.0) \
            + est_ul
        x = torch.where(mask, -tinc, NEG_INF).argmax(1, keepdim=True)
        ok = _gather(mask, x)
        sel[:, i] = torch.where(ok, x, -1)[:, 0]
        mask = mask.scatter(1, x, False)
        t = torch.where(ok, torch.clamp_min(t + _gather(tinc, x), 0.0), t)
        t_d = torch.where(ok, torch.maximum(t_d, _gather(est_ul, x)), t_d)
    return sel


def top_slots(score: torch.Tensor, valid: torch.Tensor,
              s_round: int) -> torch.Tensor:
    """Top-S over [G, N] scores by S masked argmax steps, -1 padded; equal
    scores resolve to the lowest index first."""
    g = score.shape[0]
    mask = valid.clone()
    sel = torch.full((g, s_round), -1, dtype=torch.int32,
                     device=score.device)
    for i in range(s_round):
        x = torch.where(mask, score, NEG_INF).argmax(1, keepdim=True)
        ok = _gather(mask, x)
        sel[:, i] = torch.where(ok, x, -1)[:, 0]
        mask = mask.scatter(1, x, False)
    return sel


def schedule_completions(valid: torch.Tensor, ud: torch.Tensor,
                         ul: torch.Tensor):
    """Realized schedule of one round's selection on per-slot times.

    ``valid``/``ud``/``ul``: [G, S].  Multicast distribution T_d = max t_UL,
    parallel local update, sequential upload in slot order.  Returns
    ``(round_time [G], incs [G, S], finish [G, S])``: the realized round
    time, the per-slot Eq. (1) increments the server records as T_inc, and
    each slot's completion offset (invalid slots keep the previous clock).
    """
    ud = torch.where(valid, ud, 0.0)
    ul = torch.where(valid, ul, 0.0)
    t_d = ul.amax(1)
    t = t_d
    finish = []
    for i in range(valid.shape[1]):
        t2 = torch.maximum(t, t_d + ud[:, i]) + ul[:, i]
        t = torch.where(valid[:, i], t2, t)
        finish.append(t)
    round_time = t

    t = torch.zeros_like(t_d)
    td = torch.zeros_like(t_d)
    incs = []
    for i in range(valid.shape[1]):
        v = valid[:, i]
        ntd = torch.maximum(td, ul[:, i])
        inc = (ntd - td) + torch.clamp_min(ud[:, i] - (t - td), 0.0) \
            + ul[:, i]
        incs.append(torch.where(v, inc, 0.0))
        t = torch.where(v, t + inc, t)
        td = torch.where(v, ntd, td)
    return round_time, torch.stack(incs, 1), torch.stack(finish, 1)


def schedule_gathered(valid, ud, ul):
    """(round_time [G], incs [G, S]) of :func:`schedule_completions`."""
    round_time, incs, _ = schedule_completions(valid, ud, ul)
    return round_time, incs


def schedule_selected(sel: torch.Tensor, t_ud: torch.Tensor,
                      t_ul: torch.Tensor):
    """:func:`schedule_gathered` for a [G, S] selection over [G, K] times."""
    valid = sel >= 0
    safe = torch.where(valid, sel, 0).long()
    return schedule_gathered(valid, _gather(t_ud, safe), _gather(t_ul, safe))


# ---------------------------------------------------------------------------
# Failure-aware round layer
# ---------------------------------------------------------------------------

# per-slot outcome categories (mutually exclusive; crash wins over churn
# wins over deadline wins over corrupt, so per-round counts partition the
# dispatched set)
FLAG_PAD = -1        # empty selection slot (sel == -1)
FLAG_OK = 0          # completed in time, update aggregated
FLAG_CRASH = 1       # crashed before upload (never arrived)
FLAG_CHURN = 2       # left the network mid-upload (never arrived)
FLAG_DEADLINE = 3    # healthy but finished past the round deadline
FLAG_CORRUPT = 4     # arrived in time but the update payload is garbage


def resolve_fault(fault, deadline: float | None):
    """Normalize/validate the (fault, deadline) pair of a round factory.

    ``fault``: a FaultModel (anything with ``.probs``), a (crash, churn,
    corrupt) tuple, or None.  Returns the probability triple, or None when
    fault injection is off.  Fault injection without a finite deadline is
    rejected: the server would wait forever for a crashed client.
    """
    probs = tuple(float(p) for p in getattr(fault, "probs", fault or ()))
    if probs and len(probs) != 3:
        raise ValueError(
            f"fault must be a (crash, churn, corrupt) probability triple "
            f"or a FaultModel, got {fault!r}")
    if any(p < 0.0 or p > 1.0 for p in probs):
        raise ValueError(f"fault probabilities must lie in [0, 1], "
                         f"got {probs}")
    if deadline is not None and not (float(deadline) > 0.0):
        raise ValueError(f"deadline must be a positive round duration in "
                         f"seconds (or None for no deadline), got {deadline}")
    if not any(probs):
        return None
    if deadline is None:
        raise ValueError(
            "fault injection requires a finite round deadline: a crashed "
            "client never uploads, so without a deadline the realized "
            "schedule would wait on it forever — pass deadline=<T_max>")
    return probs


def censor_slots(valid, sud, sul, incs, finish, round_time, fault_u,
                 fault: tuple[float, float, float] | None, deadline: float):
    """Apply the failure layer to one round's [G, S] schedule outcome.

    ``fault_u``: [G, 3, S] uniforms (rows: crash, churn, corrupt), unused
    when ``fault`` is None (deadline only).  Returns
    ``(obs_ud, obs_ul, obs_inc, fail, flags, round_time)``: failed slots
    (crash, churn, deadline miss) observe the deadline — the known lower
    bound on their unobserved time — and the round lasts the full deadline
    whenever any dispatched client failed.  Corrupt uploads arrived in time:
    their timing is a true observation.
    """
    dl = f32(deadline)
    if fault is not None:
        crash = fault_u[:, 0] < f32(fault[0])
        churn = fault_u[:, 1] < f32(fault[1])
        corrupt = fault_u[:, 2] < f32(fault[2])
    else:
        crash = churn = corrupt = torch.zeros_like(valid)
    missed = finish > dl
    fail = valid & (crash | churn | missed)
    flags = torch.where(
        crash, FLAG_CRASH,
        torch.where(churn, FLAG_CHURN,
                    torch.where(missed, FLAG_DEADLINE,
                                torch.where(corrupt, FLAG_CORRUPT, FLAG_OK))))
    flags = torch.where(valid, flags, FLAG_PAD).to(torch.int32)
    obs_ud = torch.where(fail, dl, sud)
    obs_ul = torch.where(fail, dl, sul)
    obs_inc = torch.where(fail, dl, incs)
    round_time = torch.where(fail.any(1), dl, round_time)
    return obs_ud, obs_ul, obs_inc, fail, flags, round_time


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def _mean(sums: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return sums / n.float().clamp_min(1.0)


def row_sum(h: torch.Tensor) -> torch.Tensor:
    """Sum over the last (ring-buffer) axis, left to right — the one order
    the plain path and the CUDA kernel both use."""
    return functools.reduce(operator.add, h.unbind(-1))


# Per-arm statistics each policy's scoring reads (the fused round gathers
# only these columns for the candidate set).  ``hist_sum_*`` are the
# ring-buffer sums over the window axis.
POLICY_STATS: dict[str, tuple[str, ...]] = {
    "fedcs": ("last_ud", "last_ul"),
    "extended_fedcs": ("hist_sum_ud", "hist_sum_ul", "hist_n"),
    "naive_ucb": ("sum_tinc", "n_sel"),
    "elementwise_ucb": ("sum_ud", "sum_ul", "n_sel"),
    "random": (),
    "oracle": (),
    "discounted_ucb": ("disc_n", "disc_ud", "disc_ul"),
    "sliding_ucb": ("hist_sum_ud", "hist_sum_ul", "hist_n", "n_sel"),
}
POLICY_NAMES: list[str] = list(POLICY_STATS)
POLICY_IDS: dict[str, int] = {n: i for i, n in enumerate(POLICY_NAMES)}
# default for the one scalar hyper-parameter each policy reads
DEFAULT_HYPERS: dict[str, float] = {
    "fedcs": 0.0, "extended_fedcs": 0.0, "naive_ucb": DEFAULT_ALPHA,
    "elementwise_ucb": DEFAULT_BETA, "random": 0.0, "oracle": 0.0,
    "discounted_ucb": DEFAULT_BETA, "sliding_ucb": DEFAULT_BETA,
}


def check_policy(policy: str) -> None:
    if policy not in POLICY_STATS:
        raise ValueError(f"unknown policy {policy!r}; have {POLICY_NAMES}")


def policy_kind(policy: str) -> str:
    """``"score"`` for the fixed-score policies (naive_ucb, random), which
    rank a per-arm score; ``"greedy"`` for the Algorithm-1 policies."""
    check_policy(policy)
    return "score" if policy in ("naive_ucb", "random") else "greedy"


def policy_decay(policy: str) -> float:
    """Per-round decay of the ``disc_*`` statistics: DEFAULT_GAMMA for
    ``discounted_ucb``, 1.0 (no decay) otherwise."""
    return DEFAULT_GAMMA if policy == "discounted_ucb" else 1.0


def state_obs(state: BanditState) -> dict[str, torch.Tensor]:
    """Full-[G, K] observation dict for :func:`policy_scores`."""
    return dict(
        n_sel=state.n_sel, sum_ud=state.sum_ud, sum_ul=state.sum_ul,
        sum_tinc=state.sum_tinc, last_ud=state.last_ud,
        last_ul=state.last_ul, hist_sum_ud=row_sum(state.hist_ud),
        hist_sum_ul=row_sum(state.hist_ul), hist_n=state.hist_n,
        disc_n=state.disc_n, disc_ud=state.disc_ud, disc_ul=state.disc_ul)


def policy_scores(policy: str, obs: dict, total, disc_total, t_ud, t_ul,
                  rand, hyper: float):
    """Every policy's per-arm selection inputs on [G, N] statistics.

    ``total``/``disc_total``: [G] counters; ``t_ud``/``t_ul``/``rand``
    aligned with ``obs``; ``hyper``: the policy's scalar knob (alpha for
    naive UCB, beta for the element-wise family).  Returns
    ``("greedy", est_ud, est_ul)`` for the Algorithm-1 policies or
    ``("score", score, None)`` for naive UCB and random.
    """
    if policy == "fedcs":
        return "greedy", obs["last_ud"], obs["last_ul"]
    if policy == "extended_fedcs":
        n = obs["hist_n"].clamp_min(1).float()
        return "greedy", obs["hist_sum_ud"] / n, obs["hist_sum_ul"] / n
    if policy == "naive_ucb":
        score = (-_mean(obs["sum_tinc"], obs["n_sel"]) / hyper
                 + ucb_bonus_arrays(obs["n_sel"], total))
        return "score", score, None
    if policy == "elementwise_ucb":
        bonus = ucb_bonus_arrays(obs["n_sel"], total)
        return ("greedy", _mean(obs["sum_ud"], obs["n_sel"]) / hyper - bonus,
                _mean(obs["sum_ul"], obs["n_sel"]) / hyper - bonus)
    if policy == "random":
        return "score", rand, None
    if policy == "oracle":
        return "greedy", t_ud, t_ul
    if policy == "discounted_ucb":
        n = obs["disc_n"]
        cold = n < f32(1e-2)
        n_safe = n.clamp_min(1e-3)
        mean_ud = torch.where(cold, 0.0, obs["disc_ud"] / n_safe)
        mean_ul = torch.where(cold, 0.0, obs["disc_ul"] / n_safe)
        log_total = torch.log(disc_total.clamp_min(2.0))[:, None]
        b = torch.sqrt(log_total / (2.0 * n_safe))
        bonus = torch.where(cold, BIG, b.clamp_max(BIG))
        return ("greedy", mean_ud / hyper - bonus, mean_ul / hyper - bonus)
    if policy == "sliding_ucb":
        n = obs["hist_n"].clamp_min(1).float()
        bonus = ucb_bonus_arrays(obs["n_sel"], total)
        return ("greedy", (obs["hist_sum_ud"] / n) / hyper - bonus,
                (obs["hist_sum_ul"] / n) / hyper - bonus)
    raise ValueError(f"unknown policy {policy!r}; have {POLICY_NAMES}")


def cand_mask(cand_idx: torch.Tensor, k: int) -> torch.Tensor:
    """[G, K] bool candidate mask from [G, C] indices (>= K = padding)."""
    g = cand_idx.shape[0]
    drop = torch.where(cand_idx < k, cand_idx, k).long()
    return torch.zeros((g, k + 1), dtype=torch.bool,
                       device=cand_idx.device).scatter(1, drop, True)[:, :k]


def scatter_cand_times(cand_idx: torch.Tensor, t_ud_c: torch.Tensor,
                       t_ul_c: torch.Tensor, k: int):
    """Spread [G, C] candidate-sliced times into zero-[G, K] buffers plus the
    [G, K] candidate mask (``cand_idx`` entries >= K are padding)."""
    g = cand_idx.shape[0]
    drop = torch.where(cand_idx < k, cand_idx, k).long()

    def spread(v):
        return v.new_zeros(g, k + 1).scatter(1, drop, v)[:, :k].contiguous()
    return spread(t_ud_c), spread(t_ul_c), cand_mask(cand_idx, k)


def round_via_mask(state, cand_mask_, t_ud, t_ul, rand, hyper, *,
                   policy: str, s_round: int, decay: float = 1.0,
                   fault: tuple | None = None, deadline: float | None = None,
                   fault_u: torch.Tensor | None = None):
    """One whole round through the unfused mask pipeline (full-[G, K]
    select + schedule + observe).  Returns ``(new_state, sel [G, S],
    round_time [G])`` — plus ``flags`` [G, S] with the failure layer on
    (``deadline`` set)."""
    kind, a, b = policy_scores(policy, state_obs(state), state.total,
                               state.disc_total, t_ud, t_ul, rand, hyper)
    sel = (top_slots(a, cand_mask_, s_round) if kind == "score"
           else greedy_slots(a, b, cand_mask_, s_round))
    valid = sel >= 0
    safe = torch.where(valid, sel, 0).long()
    sud, sul = _gather(t_ud, safe), _gather(t_ul, safe)
    if deadline is None:
        round_time, incs = schedule_gathered(valid, sud, sul)
        state = observe(state, sel, sud, sul, incs, decay=decay)
        return state, sel, round_time
    round_time, incs, finish = schedule_completions(valid, sud, sul)
    obs_ud, obs_ul, obs_inc, fail, flags, round_time = censor_slots(
        valid, sud, sul, incs, finish, round_time, fault_u, fault, deadline)
    state = observe(state, sel, obs_ud, obs_ul, obs_inc, decay=decay,
                    fail=fail)
    return state, sel, round_time, flags


def make_round_fn(policy: str, s_round: int, *, fault=None,
                  deadline: float | None = None):
    """The fused round on presampled [G, K] times:

        round_fn(state, cand_idx, t_ud, t_ul, rand, hyper, fault_u=None)
            -> (state, sel [G, S], round_time [G][, flags [G, S]])

    ``cand_idx``: [G, C] int32 sorted candidate indices (>= K = padding);
    ``rand``: the random policy's [G, K] uniforms (None otherwise);
    ``fault_u``: [G, 3, S] fault uniforms when fault injection is on.  On a
    CUDA tensor the round is one launch of the hand-written kernel
    (kernels/bandit_round.py), which updates ``state`` in place; on a CPU
    tensor it runs the plain version (kernels/ref.py).  Either way the
    caller must use the returned state and treat the one passed in as
    consumed.
    """
    from repro_torch.kernels import ops
    check_policy(policy)
    decay = policy_decay(policy)
    fault = resolve_fault(fault, deadline)

    def round_fn(state, cand_idx, t_ud, t_ul, rand, hyper, fault_u=None):
        return ops.bandit_round(state, cand_idx, t_ud, t_ul, rand, hyper,
                                policy=policy, s_round=s_round, decay=decay,
                                fault=fault, deadline=deadline,
                                fault_u=fault_u)

    return round_fn


def make_sampled_round_fn(policy: str, s_round: int, *,
                          fluctuate: bool = True, fault=None,
                          deadline: float | None = None):
    """The streamed-sampling fused round, which draws its own Eq. (8) times
    at the candidate slice:

        round_fn(state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples,
                 eta, model_bits, hyper, fault_u=None)
            -> (state, sel [G, S], round_time [G][, flags [G, S]])

    ``u2``: [G, 2, C] uniforms (row 0 throughput, row 1 capability; None
    without fluctuation); ``theta_mu``/``gamma_mu``: [G, K] means
    (``theta_mu`` carries any scenario multiplier); ``n_samples``: [K];
    ``eta``: [G].  No [K] time array exists on the kernel path.  Routing and
    the in-place contract as in :func:`make_round_fn`.
    """
    from repro_torch.kernels import ops
    check_policy(policy)
    decay = policy_decay(policy)
    fault = resolve_fault(fault, deadline)

    def round_fn(state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples,
                 eta, model_bits, hyper, fault_u=None):
        return ops.bandit_round_sampled(
            state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples, eta,
            model_bits, hyper, policy=policy, s_round=s_round, decay=decay,
            fluctuate=fluctuate, fault=fault, deadline=deadline,
            fault_u=fault_u)

    return round_fn
