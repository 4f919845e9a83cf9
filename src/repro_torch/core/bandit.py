"""PyTorch port of ``repro.core.bandit_jax``.

The bandit state and every step of one protocol round — policy scoring,
Algorithm 1 / top-S selection, the realized upload schedule, the
failure layer and the ``observe`` update — as plain functions on tensors.
The JAX package ``vmap``s them over the (eta x seed) grid; here every state
leaf and every per-round input carries an explicit leading ``[G]`` grid
axis instead, and the functions are written for it.

The round functions draw no randomness: they take their random inputs
(the random policy's uniforms ``rand``, the fault uniforms ``fault_u``,
the hierarchical round's per-cell uniforms) as tensors, so tests can hand
both packages the same numbers.  Where those inputs come from the JAX
package's keys, :func:`fault_uniforms`, :func:`random_uniforms` and
:func:`hier_cell_uniforms` draw them from a round's keys as
``bandit_jax`` does (core/prng.py).

Counterparts (JAX package -> here): ``BanditState``, ``state_tree`` /
``state_from_tree``, ``cand_idx_from_mask``, ``ucb_bonus_arrays``,
``observe``, ``greedy_slots``, ``top_slots``, ``schedule_selected`` /
``schedule_gathered`` / ``schedule_completions``, ``FLAG_*``,
``FAULT_STREAM_TAG``, ``fault_uniforms``, ``resolve_fault``,
``censor_slots``, ``POLICY_STATS``, ``policy_kind``,
``policy_scores``, ``policy_decay``, ``DEFAULT_HYPERS``,
``scatter_cand_times``, ``round_via_mask``, ``make_round_fn``,
``make_sampled_round_fn``, ``make_segmented_round_fn`` (the client-sharded
round), the index-based selection API (``candidate_mask``, ``select_*``,
``SELECT_FNS``, ``make_select_fn``) and the hierarchical cell bandit
(``cell_scores``, ``select_cells``, ``select_slots_all``, ``hier_cand_idx``
with its draw ``hier_cell_uniforms``, ``update_cell_stats``).  Not
ported: ``FUSED_MIN_K`` and ``KERNEL_MIN_K``,
the JAX package's small-K routings timed for its own CPU and TPU; here a
fused round always takes the fused path, and a Python-number alpha always
scores through ``ops.ucb_scores``.
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


@functools.cache
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def fdiv(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as IEEE float32 division, where one side may
    be a Python number.  PyTorch divides by a host scalar on the card as a
    multiplication by its reciprocal, and divides a number by a tensor as
    ``reciprocal(tensor) * number`` everywhere: two roundings, up to one
    ulp off the quotient that the JAX package and the CUDA kernels compute.
    A 0-dim float32 tensor on the operand's device takes the scalar's
    place (made once per value and device)."""
    t = a if isinstance(a, torch.Tensor) else b

    def wrap(v):
        return v if isinstance(v, torch.Tensor) else _scalar(float(v),
                                                             t.device)
    return wrap(a) / wrap(b)


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
_INT_FIELDS = ("n_sel", "total", "hist_n", "n_fail")


def state_tree(state: BanditState) -> dict:
    """Every field of ``state`` as a dict of tensors, in the JAX package's
    names and dtypes (``bandit_jax.state_tree``).  A state of one run
    (G = 1) gives the JAX package's unbatched shapes ([K], [K, W],
    scalars), a grid of G > 1 runs keeps its leading [G] axis."""
    batched = state.n_sel.shape[0] != 1
    return {name: getattr(state, name) if batched else getattr(state, name)[0]
            for name in STATE_FIELDS}


def state_from_tree(tree: dict, device="cpu") -> BanditState:
    """The inverse of :func:`state_tree`, from tensors or anything
    ``np.asarray`` takes.  An unbatched tree (``n_sel`` of one dimension,
    as the JAX package's) gives a G = 1 state; a tree without ``n_fail``
    (written before the failure layer) restores it as zeros, as
    ``bandit_jax.state_from_tree`` does.  The leaves are copies."""
    def leaf(x, dtype):                       # a copy, never a view
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype, copy=True)
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    tree = dict(tree)
    batched = np.ndim(tree["n_sel"]) == 2
    if "n_fail" not in tree:
        tree["n_fail"] = np.zeros(np.shape(tree["n_sel"]), np.int32)
    leaves = {}
    for name in STATE_FIELDS:
        x = leaf(tree[name], torch.int32 if name in _INT_FIELDS
                 else torch.float32)
        leaves[name] = x if batched else x[None]
    return BanditState(**leaves)


def first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` true entries of each row of the bool
    ``mask`` [..., N], ascending, padded with ``fill``: ``jnp.nonzero(mask,
    size=size, fill_value=fill)`` without a host sync.  Each true entry
    scatters to its rank; the rest go to a spare column, cut off."""
    rank = mask.long().cumsum(-1) - 1
    pos = torch.where(mask & (rank < size), rank, size)
    idx = torch.arange(mask.shape[-1], device=mask.device).expand(mask.shape)
    out = torch.full((*mask.shape[:-1], size + 1), fill, dtype=torch.int64,
                     device=mask.device)
    return out.scatter(-1, pos, idx)[..., :size].to(torch.int32)


def cand_idx_from_mask(mask: torch.Tensor, size: int) -> torch.Tensor:
    """[..., size] int32 sorted candidate indices from a [..., K] bool mask,
    padded with K past the last candidate (``bandit_jax.cand_idx_from_mask``):
    the fused round's input format.  ``size`` must bound the candidate
    count."""
    return first_true(mask, size, mask.shape[-1])


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
            fail: torch.Tensor | None = None,
            count_valid: torch.Tensor | None = None) -> BanditState:
    """Batch reward update for the selected clients (``idx``: [G, S]).

    Entries with ``idx < 0`` (the -1 padding of an exhausted selection) are
    no-ops.  ``decay`` (a Python float, see :func:`policy_decay`) multiplies
    the ``disc_*`` statistics before this round's observations are added;
    at exactly 1.0 they are left alone, as nothing reads them.  ``fail``
    ([G, S] bool) marks censored observations, counted in ``n_fail``.
    ``count_valid`` ([G] int) replaces the number of valid entries of
    ``idx`` in the ``total``/``disc_total`` counters: a client shard
    observes only its own clients but credits the round's global count, so
    every shard's counters stay equal to the flat path's.
    Returns a new state; ``state`` is not modified.

    Selected clients are distinct within a row, so every update is a
    scatter-add in which the padding slots add exactly zero to client 0.
    """
    g, k = state.n_sel.shape
    w = state.hist_ud.shape[2]
    idx = idx.long()
    valid = (idx >= 0) & (idx < k)
    safe = torch.where(valid, idx, 0)
    n_valid = (valid.sum(1, dtype=torch.int32) if count_valid is None
               else count_valid.to(torch.int32))

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


# fold_in tag of the fault stream: a child of the round's policy key
FAULT_STREAM_TAG = 0xFA11


def fault_uniforms(key: torch.Tensor, s_round: int) -> torch.Tensor:
    """The [..., 3, S] per-slot fault uniforms (rows: crash, churn,
    corrupt) of a round from its policy keys [..., 2]:
    ``uniform(fold_in(key, FAULT_STREAM_TAG), (3, S))``."""
    from repro_torch.core import prng
    return prng.uniform(prng.fold_in(key, FAULT_STREAM_TAG), (3, s_round))


def random_uniforms(key: torch.Tensor, k: int, first: int = 0,
                    width: int | None = None) -> torch.Tensor:
    """The random policy's [..., K] uniforms of a round from its policy
    keys [..., 2], ``uniform(key, (K,))``; with ``first``/``width`` only
    clients [first, first + width) of them."""
    from repro_torch.core import prng
    return prng.uniform(key, k if width is None else width, offset=first)


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
        score = (fdiv(-_mean(obs["sum_tinc"], obs["n_sel"]), hyper)
                 + ucb_bonus_arrays(obs["n_sel"], total))
        return "score", score, None
    if policy == "elementwise_ucb":
        bonus = ucb_bonus_arrays(obs["n_sel"], total)
        return ("greedy",
                fdiv(_mean(obs["sum_ud"], obs["n_sel"]), hyper) - bonus,
                fdiv(_mean(obs["sum_ul"], obs["n_sel"]), hyper) - bonus)
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
        return ("greedy", fdiv(mean_ud, hyper) - bonus,
                fdiv(mean_ul, hyper) - bonus)
    if policy == "sliding_ucb":
        n = obs["hist_n"].clamp_min(1).float()
        bonus = ucb_bonus_arrays(obs["n_sel"], total)
        return ("greedy", fdiv(obs["hist_sum_ud"] / n, hyper) - bonus,
                fdiv(obs["hist_sum_ul"] / n, hyper) - bonus)
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
    sel = _select_with_rand(policy, state, cand_mask_, t_ud, t_ul, rand,
                            hyper, s_round)
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


# ---------------------------------------------------------------------------
# The client-sharded (segmented) round
# ---------------------------------------------------------------------------

def make_segmented_round_fn(policy: str, s_round: int, *, n_shards: int,
                            fluctuate: bool = True, fault=None,
                            deadline: float | None = None, group=None):
    """The client-sharded twin of :func:`make_sampled_round_fn`: one round
    on a bandit state split into P contiguous client blocks (shard p owns
    clients [p*K/P, (p+1)*K/P); distributed/sharding.py):

        round_fn(state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples,
                 eta, model_bits, hyper, fault_u=None)
            -> (state, sel [G, S], round_time [G][, flags [G, S]])

    ``n_shards``: P; ``group``: the ``torch.distributed`` process group
    whose R ranks hold P/R blocks each (None: this process holds all P);
    rank r holds blocks [r*P/R, (r+1)*P/R).  ``state``: this process's sharded
    [G*P/R, K/P] state (``sharding.shard_state``); ``cand_idx``: [G, C]
    sorted global candidates, the same for every shard;
    ``theta_mu``/``gamma_mu``: [G, P/R, K/P] mean blocks; ``n_samples``:
    [P/R, K/P]; ``u2``/``eta``/``fault_u`` as in
    :func:`make_sampled_round_fn`; ``rand``: the random policy's uniforms
    at this process's clients, [G, P/R, K/P] blocks of the flat stream.  The
    JAX package runs one shard per device; here a process's blocks are a
    leading axis of its tensors, crossing shards through
    ``sharding.sum_shards`` (``psum``: the local sum, then ``all_reduce``)
    and ``sharding.gather_shards`` (``all_gather``).  Selections, round
    times and state equal the flat round's bitwise, on any number of
    ranks.

    Each shard gathers the candidates it owns; the shard sum re-assembles
    the exact [C] slice (the owner's value plus zeros), on which the
    Eq. (8) draw runs.  "score" policies (:func:`policy_kind`) rank each
    shard's own candidates with the local top-S (``ops.local_topk``, the
    hand-written kernel on the card) and merge the P*S pairs
    (``kernels/ref.segmented_topk_ref``); "greedy" policies run
    Algorithm 1 on the assembled slice, whose T_inc depends on the running
    schedule clock, so per-shard pruning would not be exact.  Each shard
    observes only its own picks and credits the global valid count
    (``observe(count_valid=)``); ``n_fail`` counts per shard.
    """
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (segmented_topk_ref,
                                         truncnorm_times_ref)
    check_policy(policy)
    decay = policy_decay(policy)
    fault = resolve_fault(fault, deadline)
    kind = policy_kind(policy)
    sg = sharding.place(int(n_shards), group)
    p, grp = sg.per_rank, sg.group

    def round_fn(state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples,
                 eta, model_bits, hyper, fault_u=None):
        g, _, k_local = theta_mu.shape
        k = k_local * sg.n_shards
        off = (torch.arange(sg.first, sg.first + p, device=cand_idx.device)
               .view(1, p, 1) * k_local)
        cvalid = cand_idx < k                            # [G, C]
        loc = cand_idx.long()[:, None, :] - off          # [G, P, C]
        in_l = cvalid[:, None, :] & (loc >= 0) & (loc < k_local)
        safe_l = torch.where(in_l, loc, 0)

        def assemble(x):                                 # [G, P, C] -> [G, C]
            return sharding.sum_shards(torch.where(in_l, x, 0), 1, grp)

        def local(x):                                    # [G, P, K/P] at C
            return x.expand(g, p, k_local).gather(2, safe_l)

        t_ud_c, t_ul_c = truncnorm_times_ref(
            u2, assemble(local(theta_mu)), assemble(local(gamma_mu)),
            assemble(local(n_samples)), eta, model_bits, fluctuate=fluctuate)
        rand_c = assemble(local(rand)) if policy == "random" else None

        rows = safe_l.reshape(g * p, -1)

        def col(name):                                   # [G*P, C] own stats
            if name.startswith("hist_sum_"):
                h = getattr(state, "hist_" + name[len("hist_sum_"):])
                return row_sum(h.gather(
                    1, rows[..., None].expand(-1, -1, h.shape[2])))
            return getattr(state, name).gather(1, rows)

        obs_c = {name: col(name) for name in POLICY_STATS[policy]}
        if kind == "greedy":
            obs = {n: assemble(v.view(g, p, -1)) for n, v in obs_c.items()}
            _, a, b = policy_scores(
                policy, obs, state.total.view(g, p)[:, 0],
                state.disc_total.view(g, p)[:, 0], t_ud_c, t_ul_c, rand_c,
                hyper)
            slots = greedy_slots(a, b, cvalid, s_round)
        else:
            # stats gathered at a foreign slot are another client's: masked
            # out before the local ranking
            _, a, _ = policy_scores(
                policy, obs_c, state.total, state.disc_total, None, None,
                None if rand_c is None else rand_c.repeat_interleave(p, 0),
                hyper)
            score = torch.where(in_l, a.view(g, p, -1), NEG_INF)
            lvals, lslots = ops.local_topk(score, in_l, s_round)
            slots = segmented_topk_ref(
                sharding.gather_shards(lvals, 1, grp),
                sharding.gather_shards(lslots, 1, grp), s_round)

        ok = slots >= 0
        safe_slot = torch.where(ok, slots, 0).long()
        sel = torch.where(ok, cand_idx.gather(1, safe_slot), -1).to(
            torch.int32)
        valid = sel >= 0
        sud, sul = t_ud_c.gather(1, safe_slot), t_ul_c.gather(1, safe_slot)
        # each shard's view of the selection: foreign picks become -1
        sel_p = sel.long()[:, None, :] - off
        own = valid[:, None, :] & (sel_p >= 0) & (sel_p < k_local)
        sel_l = torch.where(own, sel_p, -1).reshape(g * p, -1)

        def rep(x):                                      # [G, ...] per shard
            return x.repeat_interleave(p, 0)
        n_valid = rep(valid.sum(1, dtype=torch.int32))
        if deadline is None:
            round_time, incs = schedule_gathered(valid, sud, sul)
            state = observe(state, sel_l, rep(sud), rep(sul), rep(incs),
                            decay=decay, count_valid=n_valid)
            return state, sel, round_time
        round_time, incs, finish = schedule_completions(valid, sud, sul)
        obs_ud, obs_ul, obs_inc, fail, flags, round_time = censor_slots(
            valid, sud, sul, incs, finish, round_time, fault_u, fault,
            deadline)
        state = observe(state, sel_l, rep(obs_ud), rep(obs_ul), rep(obs_inc),
                        decay=decay, fail=rep(fail), count_valid=n_valid)
        return state, sel, round_time, flags

    return round_fn


# ---------------------------------------------------------------------------
# The index-based selection API (the JAX package's original public API)
#   select_*_mask(state, cand_mask, rand, true_ud, true_ul, hyper, *,
#                 s_round) -> [G, S] client indices, -1 padded
# ---------------------------------------------------------------------------

@functools.cache
def _rev_index(k: int, device: torch.device) -> torch.Tensor:
    return 0xFFFFFFFF - torch.arange(k, device=device)


def rank_keys(x: torch.Tensor, nonnegative: bool = False) -> torch.Tensor:
    """Unique int64 keys of the entries of each row of float32 ``x`` that
    order them as ``lax.top_k`` does: by value, and the lower index first
    among equal values.  The high half holds the float's bits mapped to an
    order-preserving int32 (negative floats flip their magnitude bits, so
    -0.0 ranks just below +0.0 and NaN above +inf), the low half the
    reversed index.  ``nonnegative``: the caller knows ``x >= 0`` (the
    draws' uniforms), whose bits already order them, and saves three
    passes."""
    b = x.contiguous().view(torch.int32)
    if not nonnegative:
        b = b ^ ((b >> 31) & 0x7FFFFFFF)
    return torch.add(_rev_index(x.shape[-1], x.device), b, alpha=1 << 32)


def top_k(x: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the ``n`` largest entries of each row of float32 ``x``,
    value descending, ties to the lower index — the indices of
    ``lax.top_k``.  ``torch.topk`` leaves the order of equal values
    unspecified, so it ranks :func:`rank_keys` instead."""
    return rank_keys(x).topk(n, dim=-1).indices


def candidate_mask(k: int, candidates: torch.Tensor) -> torch.Tensor:
    """[G, K] bool mask from [G, C] candidate indices (>= K dropped)."""
    return cand_mask(candidates, k)


def _top_score(score: torch.Tensor, mask: torch.Tensor,
               s_round: int) -> torch.Tensor:
    """Top-S by score over the candidate set, -1 padded."""
    idx = top_k(torch.where(mask, score, NEG_INF), s_round)
    return torch.where(mask.gather(1, idx), idx, -1).to(torch.int32)


def ucb_bonus(state: BanditState) -> torch.Tensor:
    """[G, K] UCB exploration bonus of every arm."""
    return ucb_bonus_arrays(state.n_sel, state.total)


def _naive_scores(state: BanditState, alpha,
                  use_kernel: bool = True) -> torch.Tensor:
    """Eq. (4) score of every arm.  A CUDA state scores through the
    hand-written kernel (``ops.ucb_scores``, alpha as a float); a CPU state
    through its plain version, or by the policy formula when
    ``use_kernel`` is False."""
    if use_kernel or state.n_sel.is_cuda:
        from repro_torch.kernels import ops
        return ops.ucb_scores(state.sum_tinc, state.n_sel, state.total,
                              alpha=float(alpha))
    return fdiv(-_mean(state.sum_tinc, state.n_sel), alpha) + ucb_bonus(state)


def _uniforms(rand, like: torch.Tensor) -> torch.Tensor:
    """The random policy's uniforms: ``rand`` itself, or drawn in ``like``'s
    shape from ``rand`` as a ``torch.Generator``."""
    if isinstance(rand, torch.Generator):
        return torch.rand(like.shape, generator=rand, device=like.device)
    return rand


def _select_with_rand(policy, state, mask, true_ud, true_ul, rand, hyper,
                      s_round: int) -> torch.Tensor:
    """Selection over the [G, K] candidate ``mask`` from full-[G, K]
    :func:`policy_scores` (the random policy's uniforms ``rand`` given)."""
    kind, a, b = policy_scores(policy, state_obs(state), state.total,
                               state.disc_total, true_ud, true_ul, rand,
                               hyper)
    if kind == "score":
        return _top_score(a, mask, s_round)
    return greedy_slots(a, b, mask, s_round)


def _select_via_scores(policy, state, mask, rand, true_ud, true_ul, hyper,
                       s_round: int) -> torch.Tensor:
    rand = _uniforms(rand, mask) if policy == "random" else None
    return _select_with_rand(policy, state, mask, true_ud, true_ul, rand,
                             hyper, s_round)


def _mask_fn(policy: str, doc: str):
    def select(state, cand_mask_, rand, true_ud, true_ul, hyper, *,
               s_round: int) -> torch.Tensor:
        return _select_via_scores(policy, state, cand_mask_, rand, true_ud,
                                  true_ul, hyper, s_round)
    select.__name__ = select.__qualname__ = f"select_{policy}_mask"
    select.__doc__ = doc
    return select


select_fedcs_mask = _mask_fn(
    "fedcs", "FedCS: the last observed latency is the estimate.")
select_extended_fedcs_mask = _mask_fn(
    "extended_fedcs", "Extended FedCS: mean of the last W observations.")
select_elementwise_mask = _mask_fn(
    "elementwise_ucb", "Element-wise MAB-CS (Eqs. 5-7); ``hyper`` is beta.")
select_random_mask = _mask_fn(
    "random", "Uniform S-subset of the candidates; ``rand``: [G, K] "
    "uniforms or a ``torch.Generator``.")
select_oracle_mask = _mask_fn(
    "oracle", "Greedy on this round's true times (upper bound).")
select_discounted_mask = _mask_fn(
    "discounted_ucb", "Discounted element-wise MAB-CS; ``hyper`` is beta.")
select_sliding_mask = _mask_fn(
    "sliding_ucb", "Sliding-window element-wise MAB-CS; ``hyper`` is beta.")


def select_naive_mask(state, cand_mask_, rand, true_ud, true_ul, hyper, *,
                      s_round: int) -> torch.Tensor:
    """Naive MAB-CS (Eq. 4): UCB-score top-S over the candidates; ``hyper``
    is alpha.  A CUDA state, or a Python-number alpha, scores every arm
    through ``ops.ucb_scores`` (the hand-written kernel on the card); a
    tensor alpha on a CPU state takes the policy formula."""
    if state.n_sel.is_cuda or isinstance(hyper, (int, float)):
        return _top_score(_naive_scores(state, hyper), cand_mask_, s_round)
    return _select_via_scores("naive_ucb", state, cand_mask_, rand, true_ud,
                              true_ul, hyper, s_round)


SELECT_FNS = {
    "fedcs": select_fedcs_mask,
    "extended_fedcs": select_extended_fedcs_mask,
    "naive_ucb": select_naive_mask,
    "elementwise_ucb": select_elementwise_mask,
    "random": select_random_mask,
    "oracle": select_oracle_mask,
    "discounted_ucb": select_discounted_mask,
    "sliding_ucb": select_sliding_mask,
}


def make_select_fn(policy: str, s_round: int):
    """The mask-based select function of ``policy`` with the cohort size
    bound; raises on unknown names."""
    check_policy(policy)
    return functools.partial(SELECT_FNS[policy], s_round=s_round)


def select_elementwise(state: BanditState, candidates: torch.Tensor,
                       s_round: int, beta: float = DEFAULT_BETA):
    """Element-wise MAB-CS over [G, C] candidate indices; [G, S], -1
    padded."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return select_elementwise_mask(state, mask, None, None, None, beta,
                                   s_round=s_round)


def select_naive(state: BanditState, candidates: torch.Tensor, s_round: int,
                 alpha: float = DEFAULT_ALPHA,
                 use_kernel: bool = True) -> torch.Tensor:
    """Naive MAB-CS (Eq. 4) over [G, C] candidate indices; [G, S], -1
    padded.  A CUDA state scores every arm through the hand-written kernel
    (``ops.ucb_scores``); on a CPU state ``use_kernel`` picks its plain
    version (True) or the policy formula (False)."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return _top_score(_naive_scores(state, alpha, use_kernel), mask, s_round)


def select_fedcs(state: BanditState, candidates: torch.Tensor,
                 s_round: int) -> torch.Tensor:
    """FedCS over [G, C] candidate indices; [G, S], -1 padded."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return select_fedcs_mask(state, mask, None, None, None, 0.0,
                             s_round=s_round)


def select_extended_fedcs(state: BanditState, candidates: torch.Tensor,
                          s_round: int) -> torch.Tensor:
    """Extended FedCS over [G, C] candidate indices; [G, S], -1 padded."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return select_extended_fedcs_mask(state, mask, None, None, None, 0.0,
                                      s_round=s_round)


def select_random(state: BanditState, candidates: torch.Tensor,
                  s_round: int, rand) -> torch.Tensor:
    """Uniform S-subset of [G, C] candidate indices; ``rand``: [G, K]
    uniforms or a ``torch.Generator``.  [G, S], -1 padded."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return select_random_mask(state, mask, rand, None, None, 0.0,
                              s_round=s_round)


def select_oracle(state: BanditState, candidates: torch.Tensor, s_round: int,
                  true_ud: torch.Tensor, true_ul: torch.Tensor):
    """Greedy on this round's true [G, K] times over [G, C] candidate
    indices; [G, S], -1 padded."""
    mask = candidate_mask(state.n_sel.shape[1], candidates)
    return select_oracle_mask(state, mask, None, true_ud, true_ul, 0.0,
                              s_round=s_round)


# ---------------------------------------------------------------------------
# Hierarchical two-level selection: score cells from aggregated per-cell
# statistics, then poll candidates only inside the selected cells.  Cell c
# owns clients {c, c + n_cells, ...} (the scenario's round-robin binning).
# ---------------------------------------------------------------------------

def cell_scores(cell_n: torch.Tensor, cell_tinc: torch.Tensor,
                alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Naive-UCB (Eq. 4) score of each cell from [G, n_cells] float32
    aggregates: mean observed T_inc against the exploration bonus, BIG for
    never-sampled cells."""
    nf = cell_n.clamp_min(1.0)
    total = cell_n.sum(-1, keepdim=True).clamp_min(2.0)
    bonus = torch.sqrt(torch.log(total) / (2.0 * nf))
    score = -fdiv(cell_tinc / nf, alpha) + bonus
    return torch.where(cell_n < 0.5, BIG, score)


def select_slots_all(score: torch.Tensor, s: int) -> torch.Tensor:
    """:func:`top_slots` with every slot eligible: with nothing masked, its
    S argmax steps take the order of :func:`top_k` (value descending, the
    lowest index first on ties), which one sort gives."""
    return top_k(score, s).to(torch.int32)


def select_cells(cell_n: torch.Tensor, cell_tinc: torch.Tensor,
                 s_cells: int, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Top-``s_cells`` cells by :func:`cell_scores`, never-sampled cells
    first, ties to the lowest cell id: [G, s_cells] int32."""
    return select_slots_all(cell_scores(cell_n, cell_tinc, alpha), s_cells)


def hier_cand_idx(u: torch.Tensor, cells_sel: torch.Tensor, k: int,
                  n_cells: int, n_req_cell: int) -> torch.Tensor:
    """Per-cell Resource Request of the hierarchical round.

    ``u``: [G, s_cells, m] uniforms, one row per selected cell
    (m = ceil(K / n_cells)); ``cells_sel``: [G, s_cells] cell ids.  Each
    selected cell polls the ``n_req_cell`` members with the largest
    uniforms, ties to the lower index; members past K (short cells) rank
    last and pad with K.  Returns the [G, s_cells * n_req_cell] sorted
    int32 candidates."""
    g, s_cells, m = u.shape
    if m != -(-k // n_cells):
        raise ValueError(f"u has {m} uniforms per cell; K={k} over "
                         f"{n_cells} cells needs {-(-k // n_cells)}")
    gidx = (torch.arange(m, device=u.device) * n_cells
            + cells_sel.long()[..., None])
    uu = torch.where(gidx < k, u, -1.0)
    pos = top_k(uu, n_req_cell)
    cands = torch.where(uu.gather(-1, pos) >= 0.0, gidx.gather(-1, pos), k)
    return cands.reshape(g, -1).sort(-1).values.to(torch.int32)


def hier_cell_uniforms(key: torch.Tensor, cells_sel: torch.Tensor,
                       m: int) -> torch.Tensor:
    """The uniforms :func:`hier_cand_idx` polls by, from the round's
    candidate keys [G, 2]: ``uniform(fold_in(key, c), (m,))`` for each
    selected cell c of ``cells_sel`` [G, s_cells] (cell ids on the device),
    so a cell's draw does not depend on which other cells were picked.
    Returns [G, s_cells, m]."""
    from repro_torch.core import prng
    return prng.uniform(prng.fold_in(key[..., None, :], cells_sel), m)


def update_cell_stats(cell_n: torch.Tensor, cell_tinc: torch.Tensor,
                      sel: torch.Tensor, pre_tinc: torch.Tensor,
                      post_tinc: torch.Tensor, cell_id: torch.Tensor,
                      n_cells: int):
    """Fold one round's observed T_inc into the [G, n_cells] aggregates:
    each valid pick of ``sel`` [G, S] adds 1 to its cell's count and its
    ``sum_tinc`` increment (``post_tinc - pre_tinc``, [G, K]) to its
    cell's sum; -1 slots drop."""
    v = sel >= 0
    safe = torch.where(v, sel, 0).long()
    d = torch.where(v, post_tinc.gather(1, safe) - pre_tinc.gather(1, safe),
                    0.0)
    drop = torch.where(v, cell_id[safe], n_cells)

    def add(x, val):
        x = torch.cat([x, x.new_zeros(x.shape[0], 1)], 1)
        return x.scatter_add(1, drop, val)[:, :n_cells]
    return add(cell_n, v.float()), add(cell_tinc, d)
