"""Asynchronous bounded-staleness serving (FedBuff-style) on one device —
the PyTorch port of ``repro.sim.async_engine``.

The paper's protocol closes every round.  Here in-flight client updates
live in a fixed-slot buffer carried from tick to tick, and each tick runs,
as in the JAX package:

  1. **Arrivals** — ``arrival="poisson"``: Poisson(rate x the scenario's
     diurnal load) dispatch opportunities; ``"full"``: a full cohort,
     bounded by the free slots and ``s_dispatch``.
  2. **Dispatch** — the server polls ``n_req`` candidates (clients in
     flight excluded), selects with the policy's mask selector
     (``core.bandit.make_select_fn``; ``naive_ucb`` on a CUDA state scores
     every arm through the hand-written UCB-score kernel) and admits the
     picks into free slots, stamped with their absolute completion time.
  3. **Clock** — the dispatch schedule's round time (``tick_dt=None``) or a
     fixed ``tick_dt``.
  4. **Completion** — the first ``buffer_size`` completed slots aggregate
     and feed ``bandit.observe``; slots staler than ``max_staleness``
     ticks are dropped.  With ``deadline`` set, the failure layer censors
     crashed, churned and late clients (``bandit.censor_slots``), frees
     their slots at the deadline and backs them off exponentially.

The JAX package scans the ticks in one compiled ``lax.scan``; here the
ticks are a host loop whose every step stays on the device: no tick reads
a device value on the host (``jnp.nonzero(size=)`` becomes
``bandit.first_true``, a scatter of ranks; ``.at[].set(mode="drop")`` a
scatter into a buffer with one spare entry, cut off).

Random inputs go through a replay seam, as the sync engine's
(``sim/engine.RoundDraws`` -> ``run_rounds``): a :class:`TickDraws` holds
one tick's draws, and :func:`serve` / :func:`run_segment` take them as an
input or draw them with :func:`draw_tick`.  Each stream of a tick is drawn
from its own ``torch.Generator`` seeded from ``np.random.SeedSequence([seed,
stream, tick])``, so every tick's draws are a pure function of (seed,
absolute tick) — the JAX package's ``tick_keys`` guarantee, which makes a
snapshot resume bitwise and lets a JAX checkpoint resume here (it carries
no generator state).  The streams differ from ``jax.random``'s: the tests
hand both packages JAX's per-tick draws.

Counterparts (JAX package -> here): ``AsyncConfig``, ``AsyncState``,
``dispatch_plan``, ``admit``, ``completion_plan``, ``gather_aggregated``,
``staleness_weights``, ``poll_inputs``, ``advance_clock``, ``_tick_fn``,
``tick_keys`` -> :func:`draw_tick`, ``AsyncResult``, ``run_segment``,
``serve``, ``snapshot_tree``, ``state_from_snapshot``.  Degenerate
reduction: under ``arrival="full"``, schedule pacing, ``buffer_size ==
s_dispatch`` and an unbounded staleness cap, a tick on given draws is the
sync engine's unfused round on the same draws, bitwise
(tests/test_torch_async_engine.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import bandit
from repro_torch.sim import engine as sim
from repro_torch.sim.resources import PAPER_MODEL_BITS
from repro_torch.sim.scenarios import Scenario, get_scenario

# the per-tick random streams; a stream's index seeds its generator, so one
# stream's draws never depend on which others a run draws.  "perm" is the
# learning-coupled twin's (fl/engine.async_accuracy_run)
TICK_STREAMS = ("cand", "time", "pol", "fault", "cong", "churn", "arr",
                "perm")


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Static knobs of the serving loop (``repro.sim.async_engine``'s, same
    fields, defaults and checks).

    ``n_slots`` bounds the in-flight population; ``buffer_size`` is the
    FedBuff aggregation batch per tick; ``max_staleness`` (ticks) evicts
    updates, completed or not, whose base model is too old; ``s_dispatch``
    bounds the per-tick cohort; ``n_req`` is the per-tick poll size.
    ``tick_dt=None`` paces the clock by each tick's dispatch schedule
    (``idle_dt`` when nothing dispatches).  ``arrival`` is ``"poisson"``
    (rate ``arrival_rate`` times the diurnal load) or ``"full"``.
    ``staleness_power`` shapes the FL twin's weight ``(1 + s)**-p``.
    ``deadline`` (seconds, None = off) switches on the failure layer with
    capped exponential backoff ``backoff_base * 2**(streak-1)`` seconds, at
    most ``backoff_max``.
    """

    n_slots: int = 32
    buffer_size: int = 5
    max_staleness: int = 50
    s_dispatch: int = 5
    n_req: int = 10
    tick_dt: float | None = None
    idle_dt: float = 1.0
    arrival: str = "poisson"
    arrival_rate: float = 5.0
    staleness_power: float = 0.5
    deadline: float | None = None
    backoff_base: float = 2.0
    backoff_max: float = 64.0

    def __post_init__(self):
        if self.deadline is not None and not self.deadline > 0.0:
            raise ValueError("deadline must be a positive round duration "
                             f"in seconds (or None), got {self.deadline}")
        if not self.backoff_base > 0.0 or self.backoff_max < \
                self.backoff_base:
            raise ValueError("backoff must satisfy 0 < backoff_base <= "
                             "backoff_max")
        if self.n_slots < self.s_dispatch:
            raise ValueError(f"n_slots={self.n_slots} < "
                             f"s_dispatch={self.s_dispatch}: a full cohort "
                             "must fit in the buffer")
        if self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if self.tick_dt is not None and not self.tick_dt > 0.0:
            raise ValueError("tick_dt must be positive (or None)")
        if not self.idle_dt > 0.0:
            raise ValueError("idle_dt must be positive (elapsed time is "
                             "strictly monotone)")
        if self.arrival not in ("poisson", "full"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")


_INT_FIELDS = ("buf_client", "buf_tick", "buf_flag", "fail_streak", "tick",
               "n_admitted", "n_aggregated", "n_dropped", "n_failed",
               "n_corrupt")


@dataclasses.dataclass(frozen=True)
class AsyncState:
    """Everything the serving loop carries across ticks, on the run's
    device.  Slots with ``buf_client < 0`` are free; an occupied slot holds
    its client, absolute completion time, dispatch tick and the realized
    (t_UD, t_UL, T_inc) the bandit observes when it completes.  ``bandit``
    is a G = 1 ``core.bandit.BanditState``."""

    bandit: bandit.BanditState
    buf_client: torch.Tensor     # [B] int32, -1 = free
    buf_done: torch.Tensor       # [B] f32 absolute completion time
    buf_tick: torch.Tensor       # [B] int32 dispatch tick
    buf_ud: torch.Tensor         # [B] f32 realized t_UD
    buf_ul: torch.Tensor         # [B] f32 realized t_UL
    buf_inc: torch.Tensor        # [B] f32 realized T_inc observation
    buf_flag: torch.Tensor       # [B] int32 bandit.FLAG_* (failure layer)
    mean_theta: torch.Tensor     # [K] f32 churn-evolving mean throughput
    mean_gamma: torch.Tensor     # [K] f32 churn-evolving mean capability
    fail_streak: torch.Tensor    # [K] int32 consecutive delivery failures
    backoff_until: torch.Tensor  # [K] f32 not pollable before this time
    now: torch.Tensor            # [] f32 server clock
    tick: torch.Tensor           # [] int32 next tick index (0-based)
    n_admitted: torch.Tensor     # [] int32 cumulative dispatched updates
    n_aggregated: torch.Tensor   # [] int32 cumulative aggregated updates
    n_dropped: torch.Tensor      # [] int32 cumulative over-stale evictions
    n_failed: torch.Tensor       # [] int32 cumulative crash/churn/deadline
    n_corrupt: torch.Tensor      # [] int32 cumulative corrupted arrivals

    @staticmethod
    def create(env: sim.EnvArrays, cfg: AsyncConfig) -> "AsyncState":
        k = env.mean_theta.shape[0]
        b, dev = cfg.n_slots, env.mean_theta.device

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        i32 = torch.int32
        return AsyncState(
            bandit=bandit.BanditState.create(1, k, device=dev),
            buf_client=torch.full((b,), -1, dtype=i32, device=dev),
            buf_done=z(b), buf_tick=z(b, dtype=i32), buf_ud=z(b),
            buf_ul=z(b), buf_inc=z(b), buf_flag=z(b, dtype=i32),
            mean_theta=env.mean_theta.clone(),
            mean_gamma=env.mean_gamma.clone(),
            fail_streak=z(k, dtype=i32), backoff_until=z(k), now=z(),
            tick=z(dtype=i32), n_admitted=z(dtype=i32),
            n_aggregated=z(dtype=i32), n_dropped=z(dtype=i32),
            n_failed=z(dtype=i32), n_corrupt=z(dtype=i32))

    def replace(self, **kw) -> "AsyncState":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The seam: one tick's random inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TickDraws:
    """One tick's random inputs (the JAX package draws them from the tick's
    key dict inside the tick)."""

    cand_mask: torch.Tensor               # [K] bool Resource-Request poll
    u_time: torch.Tensor | None           # [2, K] Eq. (8) uniforms (theta,
    #                                       gamma); None without fluctuation
    n_arr: torch.Tensor                   # [] int32 dispatch opportunities
    rand: torch.Tensor | None = None      # [K] random policy's uniforms
    fault_u: torch.Tensor | None = None   # [3, s_dispatch] crash/churn/corrupt
    cong: torch.Tensor | None = None      # [cells] standard normals
    churn: torch.Tensor | None = None     # [4] churn uniforms
    orders: torch.Tensor | None = None    # [K, E, cap] FL twin's epoch orders

    def to(self, device) -> "TickDraws":
        return TickDraws(**{f.name: None if (x := getattr(self, f.name))
                            is None else x.to(device)
                            for f in dataclasses.fields(self)})


def tick_generator(seed: int, stream: str, tick: int,
                   device) -> torch.Generator:
    """The generator of ``stream`` at absolute ``tick`` of a run seeded
    ``seed``: seeded from ``np.random.SeedSequence([seed, stream index,
    tick])``, a pure function of the three."""
    ss = np.random.SeedSequence([int(seed), TICK_STREAMS.index(stream),
                                 int(tick)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return gen


def arrival_rate(scen: Scenario, cfg: AsyncConfig, tick: int) -> float:
    """The Poisson rate at absolute ``tick``: ``arrival_rate`` times the
    scenario's diurnal load of round ``tick + 1`` (float64 on the host)."""
    rate = cfg.arrival_rate
    if scen.diurnal_amp > 0.0 and scen.diurnal_period > 0:
        rate *= max(1.0 + scen.diurnal_amp * math.sin(
            2.0 * math.pi * (tick + 1) / scen.diurnal_period), 0.05)
    return rate


def draw_tick(seed: int, tick: int, *, k: int, cfg: AsyncConfig,
              scen: Scenario, policy: str, fluctuate: bool = True,
              device="cpu") -> TickDraws:
    """Absolute ``tick``'s draws of a run seeded ``seed``: the candidate
    poll (the top ``n_req`` of K uniforms, ties to the lower index), the
    Eq. (8) uniforms, the random policy's uniforms, the fault uniforms
    (with a deadline and an active fault model), the congestion normals,
    the churn uniforms and the arrival count (``torch.poisson``, or
    ``s_dispatch`` under ``arrival="full"``), each stream from its own
    :func:`tick_generator`."""
    def gen(stream):
        return tick_generator(seed, stream, tick, device)

    def rand(stream, *shape):
        return torch.rand(shape, generator=gen(stream), device=device)

    cand = sim.topk_lowest(rand("cand", k)[None], cfg.n_req)
    if cfg.arrival == "full":
        n_arr = torch.full((), cfg.s_dispatch, dtype=torch.int32,
                           device=device)
    else:
        lam = torch.full((), arrival_rate(scen, cfg, tick), device=device)
        n_arr = torch.poisson(lam, generator=gen("arr")).to(torch.int32)
    fault = bandit.resolve_fault(scen.fault, cfg.deadline)
    return TickDraws(
        cand_mask=bandit.cand_mask(cand, k)[0],
        u_time=rand("time", 2, k) if fluctuate else None, n_arr=n_arr,
        rand=rand("pol", k) if policy == "random" else None,
        fault_u=rand("fault", 3, cfg.s_dispatch) if fault is not None
        else None,
        cong=(torch.randn(scen.congestion_cells, generator=gen("cong"),
                          device=device)
              if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0
              else None),
        churn=rand("churn", 4) if scen.churn_prob > 0.0 else None)


# ---------------------------------------------------------------------------
# The tick's phases (shared with the learning-coupled twin)
# ---------------------------------------------------------------------------

def put_drop(buf: torch.Tensor, target: torch.Tensor, vals) -> torch.Tensor:
    """``buf.at[target].set(vals, mode="drop")``: targets equal to
    ``len(buf)`` land in a spare entry that is cut off."""
    spare = torch.cat([buf, buf.new_zeros(1)])
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(target.shape, vals, dtype=buf.dtype,
                          device=buf.device)
    return spare.scatter(0, target.long(), vals.to(buf.dtype))[:-1]


def dispatch_plan(state: AsyncState, cand_mask: torch.Tensor, rand,
                  t_ud: torch.Tensor, t_ul: torch.Tensor,
                  n_arrivals: torch.Tensor, hyper, select_fn,
                  cfg: AsyncConfig):
    """Phase 1: poll, select, and plan the cohort's admission.

    ``cand_mask``: the tick's raw [K] poll; ``t_ud``/``t_ul``: [1, K];
    ``rand``: the random policy's [1, K] uniforms (or None).  Clients in
    flight are excluded from the poll.  Returns ``(sel, target, finish, rt,
    incs, n_disp)``: the [s_dispatch] selection (-1 padded), each member's
    slot (``n_slots`` = dropped), its completion offset from ``now``, the
    cohort's round time and per-slot T_inc observations."""
    k = t_ud.shape[1]
    occ = torch.where(state.buf_client >= 0, state.buf_client, k)
    inflight = put_drop(torch.zeros(k, dtype=torch.bool,
                                    device=occ.device), occ, True)
    cand_mask = cand_mask & ~inflight

    sel = select_fn(state.bandit, cand_mask[None], rand, t_ud, t_ul,
                    hyper)[0]

    free = state.buf_client < 0
    n_disp = torch.minimum(n_arrivals.to(torch.int32), free.sum(
        dtype=torch.int32).clamp_max(cfg.s_dispatch))
    sel = torch.where(torch.arange(cfg.s_dispatch, device=sel.device)
                      < n_disp, sel, -1)

    valid = sel >= 0
    safe = torch.where(valid, sel, 0).long()
    rt, incs, finish = bandit.schedule_completions(
        valid[None], t_ud[0, safe][None], t_ul[0, safe][None])
    free_idx = bandit.first_true(free, cfg.s_dispatch, cfg.n_slots)
    target = torch.where(valid, free_idx, cfg.n_slots)
    return sel, target, finish[0], rt[0], incs[0], n_disp


def admit(state: AsyncState, sel, target, finish, incs, t_ud, t_ul,
          ud=None, ul=None, flags=None) -> AsyncState:
    """Scatter the planned cohort into its slots (phase 1b).  ``ud``/``ul``
    (per cohort slot) override the ``t_ud[sel]`` gather — the failure
    layer stores censored observations — and ``flags`` stamps each slot's
    FLAG_* outcome (zeros when absent)."""
    valid = sel >= 0
    safe = torch.where(valid, sel, 0).long()
    ud = t_ud[0, safe] if ud is None else ud
    ul = t_ul[0, safe] if ul is None else ul
    flags = torch.zeros_like(sel) if flags is None else flags.clamp_min(0)
    return state.replace(
        buf_client=put_drop(state.buf_client, target, sel),
        buf_done=put_drop(state.buf_done, target, state.now + finish),
        buf_tick=put_drop(state.buf_tick, target, state.tick.expand(
            target.shape)),
        buf_ud=put_drop(state.buf_ud, target, ud),
        buf_ul=put_drop(state.buf_ul, target, ul),
        buf_inc=put_drop(state.buf_inc, target, incs),
        buf_flag=put_drop(state.buf_flag, target, flags),
        n_admitted=state.n_admitted + valid.sum(dtype=torch.int32))


def completion_plan(state: AsyncState, now: torch.Tensor, cfg: AsyncConfig,
                    failed=None):
    """Phase 2: which slots aggregate, drop, or wait.  ``now`` is the
    post-advance clock; a slot's staleness is ``tick - buf_tick``.
    Over-stale slots (completed or not) drop; of the other completed slots
    the first ``buffer_size`` in slot order aggregate.  Returns
    ``(agg_slots [buffer_size] (fill n_slots), agg_mask, drop_mask,
    staleness)``, plus ``fail_mask`` when ``failed`` ([B] bool, failure
    layer) is given: failed slots whose timeout passed, outside the
    aggregation quota."""
    occupied = state.buf_client >= 0
    staleness = state.tick - state.buf_tick
    drop_mask = occupied & (staleness > cfg.max_staleness)
    ready = occupied & (state.buf_done <= now) & ~drop_mask
    fail_mask = None
    if failed is not None:
        fail_mask = ready & failed
        ready = ready & ~failed
    rank = ready.to(torch.int32).cumsum(0) - 1
    agg_mask = ready & (rank < cfg.buffer_size)
    agg_slots = bandit.first_true(agg_mask, cfg.buffer_size, cfg.n_slots)
    if failed is not None:
        return agg_slots, agg_mask, drop_mask, staleness, fail_mask
    return agg_slots, agg_mask, drop_mask, staleness


def gather_aggregated(state: AsyncState, agg_slots: torch.Tensor,
                      cfg: AsyncConfig):
    """The aggregating slots' observations; fill slots gather slot 0 under
    client index -1, which ``bandit.observe`` drops."""
    in_range = agg_slots < cfg.n_slots
    safe = torch.where(in_range, agg_slots, 0).long()
    idx = torch.where(in_range, state.buf_client[safe], -1)
    return idx, state.buf_ud[safe], state.buf_ul[safe], state.buf_inc[safe]


def staleness_weights(staleness: torch.Tensor, power: float) -> torch.Tensor:
    """FedBuff staleness discount ``(1 + s)**-power`` (s in ticks), as
    ``pow`` with a float32 exponent tensor: a Python exponent of -0.5 would
    become ``rsqrt``, which is further from XLA's ``pow`` (both within
    rtol 1e-6 of it; tests/test_torch_async_engine.py)."""
    s = staleness.float().clamp_min(0.0)
    return torch.pow(1.0 + s, torch.full((), -power, device=s.device))


def poll_inputs(scen: Scenario, env: sim.EnvArrays, state: AsyncState,
                d: TickDraws, *, eta: torch.Tensor, model_bits: float,
                fluctuate: bool):
    """One tick's environment from its draws: Eq. (8) times under the
    scenario's throughput multiplier (round ``tick + 1``, read on the
    device), the candidate poll and the arrival count.  Returns ``(t_ud
    [1, K], t_ul [1, K], cand_mask [K], n_arr)``; shared verbatim by the
    time-only tick and the FL twin."""
    mu_t = state.mean_theta[None]
    if scen.diurnal_amp > 0.0 and scen.diurnal_period > 0:
        mu_t = mu_t * sim.scenario_diurnal_mult(scen, state.tick[None] + 1)
    if d.cong is not None:
        mu_t = mu_t * torch.exp(scen.congestion_sigma * d.cong)[env.cell_id]
    u_t, u_g = (None, None) if d.u_time is None else (d.u_time[0][None],
                                                      d.u_time[1][None])
    t_ud, t_ul = sim.sample_times(env.n_samples, mu_t,
                                  state.mean_gamma[None], eta, model_bits,
                                  u_t, u_g, fluctuate=fluctuate)
    return t_ud, t_ul, d.cand_mask, d.n_arr


def advance_clock(sel: torch.Tensor, rt: torch.Tensor,
                  cfg: AsyncConfig) -> torch.Tensor:
    """The tick's clock step: the dispatch schedule's round time under
    schedule pacing (``idle_dt`` when nothing dispatched), else the fixed
    ``tick_dt``."""
    if cfg.tick_dt is not None:
        return torch.full((), cfg.tick_dt, device=rt.device)
    return torch.where((sel >= 0).any(), rt, bandit.f32(cfg.idle_dt))


def churn(scen: Scenario, state: AsyncState, d: TickDraws):
    """The churn step's new (mean_theta, mean_gamma)."""
    if scen.churn_prob <= 0.0:
        return state.mean_theta, state.mean_gamma
    t, g = sim.churn_step(d.churn[None], state.mean_theta[None],
                          state.mean_gamma[None], scen.churn_prob)
    return t[0], g[0]


def _tick_fn(scen: Scenario, env: sim.EnvArrays, cfg: AsyncConfig, *,
             policy: str, eta: torch.Tensor, model_bits: float, hyper,
             fluctuate: bool, model=None):
    """The per-tick transition ``tick(state, d) -> (state, trace)`` on the
    draws ``d``.  ``cfg.deadline`` switches on the failure layer; at None
    its branches are skipped and the tick is the fault-free one.

    ``model`` couples a model to the tick (``fl.engine.async_fl_segment``):
    it is called once a tick as ``model(state, d, sel, target, agg_slots,
    agg_mask, staleness)`` after the completion plan, on the state with the
    cohort admitted and the counters not yet advanced, to train the
    dispatched cohort and apply the tick's aggregate; the dict it returns
    joins the tick's trace."""
    select_fn = bandit.make_select_fn(policy, cfg.s_dispatch)
    decay = bandit.policy_decay(policy)
    failure = cfg.deadline is not None
    fault = bandit.resolve_fault(scen.fault, cfg.deadline)
    k = env.mean_theta.shape[0]
    i32 = torch.int32

    def tick(state: AsyncState, d: TickDraws):
        t_ud, t_ul, cand_mask, n_arr = poll_inputs(
            scen, env, state, d, eta=eta, model_bits=model_bits,
            fluctuate=fluctuate)
        if failure:     # clients cooling down after a failure: not pollable
            cand_mask = cand_mask & (state.backoff_until <= state.now)
        rand = None if d.rand is None else d.rand[None]
        sel, target, finish, rt, incs, _ = dispatch_plan(
            state, cand_mask, rand, t_ud, t_ul, n_arr, hyper, select_fn, cfg)
        if failure:
            valid = sel >= 0
            safe = torch.where(valid, sel, 0).long()
            obs_ud, obs_ul, obs_inc, fail, flags, rt = (
                x[0] for x in bandit.censor_slots(
                    valid[None], t_ud[0, safe][None], t_ul[0, safe][None],
                    incs[None], finish[None], rt[None],
                    None if d.fault_u is None else d.fault_u[None], fault,
                    cfg.deadline))
            # a failed update never arrives: its slot times out, and frees
            # for re-dispatch, at the deadline
            finish = torch.where(fail, bandit.f32(cfg.deadline), finish)
            state = admit(state, sel, target, finish, obs_inc, t_ud, t_ul,
                          ud=obs_ud, ul=obs_ul, flags=flags)
        else:
            state = admit(state, sel, target, finish, incs, t_ud, t_ul)

        dt = advance_clock(sel, rt, cfg)
        now = state.now + dt

        if failure:
            failed_slot = ((state.buf_flag >= bandit.FLAG_CRASH)
                           & (state.buf_flag <= bandit.FLAG_DEADLINE))
            agg_slots, agg_mask, drop_mask, staleness, fail_mask = \
                completion_plan(state, now, cfg, failed=failed_slot)
            fail_slots = bandit.first_true(fail_mask, cfg.n_slots,
                                           cfg.n_slots)
            # one observe a tick (decay applies once): arrived slots
            # uncensored, failed completions censored at the deadline
            a = gather_aggregated(state, agg_slots, cfg)
            f = gather_aggregated(state, fail_slots, cfg)
            idx, ud_o, ul_o, inc_o = (torch.cat([x, y]) for x, y in zip(a, f))
            fail_o = torch.cat([torch.zeros_like(a[0], dtype=torch.bool),
                                torch.ones_like(f[0], dtype=torch.bool)])
            new_bandit = bandit.observe(
                state.bandit, idx[None], ud_o[None], ul_o[None], inc_o[None],
                decay=decay, fail=fail_o[None])
        else:
            agg_slots, agg_mask, drop_mask, staleness = completion_plan(
                state, now, cfg)
            fail_mask = torch.zeros_like(agg_mask)
            idx, ud_o, ul_o, inc_o = gather_aggregated(state, agg_slots, cfg)
            new_bandit = bandit.observe(state.bandit, idx[None], ud_o[None],
                                        ul_o[None], inc_o[None], decay=decay)

        extra = {} if model is None else model(
            state, d, sel, target, agg_slots, agg_mask, staleness)
        n_agg = agg_mask.sum(dtype=i32)
        n_drop = drop_mask.sum(dtype=i32)
        n_fail = fail_mask.sum(dtype=i32)
        n_corr = (agg_mask & (state.buf_flag == bandit.FLAG_CORRUPT)).sum(
            dtype=i32)
        clear = agg_mask | drop_mask | fail_mask
        buf_client = torch.where(clear, -1, state.buf_client)

        fail_streak, backoff_until = state.fail_streak, state.backoff_until
        if failure:
            # arrived => streak resets; failed => streak += 1 and the client
            # backs off min(base * 2**(streak-1), max) seconds (a client is
            # in flight at most once, so the scatters are disjoint)
            arrived_c = torch.where(agg_mask, state.buf_client, k)
            failed_c = torch.where(fail_mask, state.buf_client, k)
            new_streak = state.fail_streak[torch.where(
                fail_mask, state.buf_client, 0).long()] + 1
            delay = (cfg.backoff_base * torch.exp2(
                new_streak.float() - 1.0)).clamp_max(cfg.backoff_max)
            fail_streak = put_drop(put_drop(fail_streak, arrived_c, 0),
                                   failed_c, new_streak)
            backoff_until = put_drop(backoff_until, failed_c, now + delay)

        mean_theta, mean_gamma = churn(scen, state, d)
        state = state.replace(
            bandit=new_bandit, buf_client=buf_client,
            mean_theta=mean_theta, mean_gamma=mean_gamma,
            fail_streak=fail_streak, backoff_until=backoff_until,
            now=now, tick=state.tick + 1,
            n_aggregated=state.n_aggregated + n_agg,
            n_dropped=state.n_dropped + n_drop,
            n_failed=state.n_failed + n_fail,
            n_corrupt=state.n_corrupt + n_corr)
        trace = {
            "dt": dt, "now": now, "selected": sel,
            "admitted": (sel >= 0).sum(dtype=i32),
            "aggregated": n_agg, "dropped": n_drop, "failed": n_fail,
            "corrupt": n_corr, "buffered": (buf_client >= 0).sum(dtype=i32),
            "max_staleness": torch.where(agg_mask, staleness, -1).max(),
            **extra,
        }
        return state, trace

    return tick


# ---------------------------------------------------------------------------
# Segments and the entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AsyncResult:
    """Traces of a serving segment (host numpy, [T]-leading) and the final
    state.  ``selected`` is [T, s_dispatch] (-1 padded); ``max_staleness``
    is the per-tick maximum staleness among aggregated updates (-1 when
    none aggregated)."""

    dt: np.ndarray
    elapsed: np.ndarray
    selected: np.ndarray
    admitted: np.ndarray
    aggregated: np.ndarray
    dropped: np.ndarray
    failed: np.ndarray          # crash/churn/deadline timeouts (censored)
    corrupt: np.ndarray         # arrived-but-garbage (subset of aggregated)
    buffered: np.ndarray
    max_staleness: np.ndarray
    state: AsyncState

    def conserved(self) -> bool:
        """admitted == aggregated + dropped + failed + still buffered,
        cumulatively at every tick."""
        return bool(np.all(np.cumsum(self.admitted)
                           == np.cumsum(self.aggregated)
                           + np.cumsum(self.dropped)
                           + np.cumsum(self.failed) + self.buffered))


def stack_traces(traces: list[dict]) -> dict[str, np.ndarray]:
    """Per-tick trace dicts -> host numpy arrays, [T]-leading (one copy per
    key at the end of a segment)."""
    return {key: torch.stack([t[key] for t in traces]).cpu().numpy()
            for key in traces[0]}


def run_segment(state: AsyncState, draws: Iterable[TickDraws],
                scen: Scenario, env: sim.EnvArrays, cfg: AsyncConfig, *,
                policy: str, eta: float, model_bits: float, hyper: float,
                fluctuate: bool = True, model=None):
    """Run one tick per element of ``draws`` from ``state``, with the model
    hook ``model`` of :func:`_tick_fn`.  Returns ``(state, traces)``, the
    traces stacked to host numpy."""
    dev = env.mean_theta.device
    tick = _tick_fn(scen, env, cfg, policy=policy,
                    eta=torch.tensor([eta], dtype=torch.float32, device=dev),
                    model_bits=float(model_bits), hyper=float(hyper),
                    fluctuate=fluctuate, model=model)
    traces = []
    for d in draws:
        state, tr = tick(state, d)
        traces.append(tr)
    if not traces:
        raise ValueError("a segment needs at least one tick")
    return state, stack_traces(traces)


def serve(scenario: str | Scenario = "paper-baseline",
          policy: str = "elementwise_ucb",
          *, n_ticks: int = 200, total_ticks: int | None = None,
          t0: int = 0, seed: int = 0, cfg: AsyncConfig | None = None,
          n_clients: int = 100, env_seed: int = 0,
          env: sim.EnvArrays | None = None,
          state: AsyncState | None = None, eta: float = 1.0,
          model_bits: float = PAPER_MODEL_BITS, hyper: float | None = None,
          fluctuate: bool = True, draws: Iterable[TickDraws] | None = None,
          device=None) -> AsyncResult:
    """Run (or resume) an async serving simulation for ``n_ticks`` ticks;
    the arguments are those of the JAX package's ``serve``, plus ``draws``
    and ``device`` (None = the card; ``"cpu"`` runs the plain PyTorch
    path).

    ``draws`` (one :class:`TickDraws` per tick, on the run's device) replay
    given random inputs; by default tick ``t`` draws
    ``draw_tick(seed, t, ...)``.  Resuming from a snapshot means calling
    again with the same seed and ``t0 = state.tick``: the result is bitwise
    the uninterrupted run's.  ``total_ticks`` (default ``t0 + n_ticks``)
    is the run's horizon; a segment must lie inside it.
    """
    device = sim.resolve_device(device)
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    cfg = cfg or AsyncConfig()
    if env is None:
        env = sim.EnvArrays.from_scenario(
            scen, scen.build_env(n_clients, np.random.default_rng(env_seed)),
            device)
    elif env.mean_theta.device != device:
        raise ValueError(f"env lies on {env.mean_theta.device}, the run on "
                         f"{device}")
    k = int(env.mean_theta.shape[0])
    if cfg.s_dispatch > k:
        raise ValueError(f"s_dispatch={cfg.s_dispatch} exceeds "
                         f"n_clients={k}: cannot dispatch more clients "
                         f"than exist")
    bandit.check_policy(policy)
    bandit.resolve_fault(scen.fault, cfg.deadline)   # validates the combo
    if hyper is None:
        hyper = bandit.DEFAULT_HYPERS[policy]
    if total_ticks is None:
        total_ticks = t0 + n_ticks
    if not (0 <= t0 and t0 + n_ticks <= total_ticks):
        raise ValueError(f"segment [{t0}, {t0 + n_ticks}) outside "
                         f"total_ticks={total_ticks}")
    if state is None:
        if t0 != 0:
            raise ValueError("t0 != 0 requires a resumed state")
        state = AsyncState.create(env, cfg)
    if draws is None:
        draws = (draw_tick(seed, t, k=k, cfg=cfg, scen=scen, policy=policy,
                           fluctuate=fluctuate, device=device)
                 for t in range(t0, t0 + n_ticks))
    elif len(draws := list(draws)) != n_ticks:
        raise ValueError(f"{len(draws)} draws for {n_ticks} ticks")
    state, tr = run_segment(state, draws, scen, env, cfg, policy=policy,
                            eta=eta, model_bits=model_bits, hyper=hyper,
                            fluctuate=fluctuate)
    return AsyncResult(
        dt=tr["dt"], elapsed=tr["now"], selected=tr["selected"],
        admitted=tr["admitted"], aggregated=tr["aggregated"],
        dropped=tr["dropped"], failed=tr["failed"], corrupt=tr["corrupt"],
        buffered=tr["buffered"], max_staleness=tr["max_staleness"],
        state=state)


# ---------------------------------------------------------------------------
# Snapshots (checkpoint/ckpt.py-compatible plain-dict trees)
# ---------------------------------------------------------------------------

def snapshot_tree(state: AsyncState) -> dict:
    """An :class:`AsyncState` as a plain dict of tensors in the JAX
    package's names, shapes and dtypes (the bandit through
    ``bandit.state_tree``), which ``checkpoint.ckpt.CheckpointManager``
    saves."""
    d = {f.name: getattr(state, f.name)
         for f in dataclasses.fields(state) if f.name != "bandit"}
    d["bandit"] = bandit.state_tree(state.bandit)
    return d


def state_from_snapshot(tree: dict, device=None) -> AsyncState:
    """The inverse of :func:`snapshot_tree`, from tensors or numpy arrays
    (a restored checkpoint, the port's or the JAX package's), on
    ``device`` (None = the card)."""
    device = sim.resolve_device(device)

    def leaf(name, x):
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype, copy=True)
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    kw = {k: leaf(k, v) for k, v in tree.items() if k != "bandit"}
    kw["bandit"] = bandit.state_from_tree(tree["bandit"], device)
    return AsyncState(**kw)
