"""The port's async serving engine (repro_torch.sim.async_engine) against the
JAX package's ``sim.async_engine``, on the CPU.

  1. the tick on JAX's per-tick draws (``tick_keys`` -> ``poll_inputs``,
     the random policy's and the fault uniforms, congestion and churn draws)
     against JAX's ``serve``: both ``_CFGS`` regimes of
     tests/test_async_engine.py, fedcs, elementwise, discounted and naive
     UCB and random, and the failure layer (flaky-clients with a deadline);
  2. the degenerate reduction: under ``_SYNC_CFG`` the port's ``serve`` on
     given draws equals the port's sync ``run_rounds`` and ``run_replay``
     on the same draws, bitwise;
  3. the serving invariants, property-based, on port-only runs;
  4. crash and resume through the port's ``CheckpointManager``, bitwise;
  5. the helpers: ``staleness_weights``, the draw step, validation.

Tolerances: selections, admitted, aggregated, dropped, failed, corrupt,
buffered and every integer leaf of the state exact; ``dt``, ``elapsed`` and
float state within rtol 1e-6 (the Eq. (8) transform's erfinv and the UCB
bonus's log carry last-ulp differences of XLA's against PyTorch's).  Under
client churn, 1e-5: a churned client's new mean throughput comes from the
float32 LTE link budget (``sim/engine.throughput_bps``: log10, a power of
ten, log2), within 2e-6 of XLA's, and its times inherit that.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _hyp import given, settings, st  # noqa: E402
from _torch_parity import async_trees_match, jax_tick_draws  # noqa: E402

from repro.sim import async_engine as jae  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.sim import async_engine as ae  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

RTOL = 1e-6
CHURN_RTOL = 1e-5
TRACES = ("selected", "admitted", "aggregated", "dropped", "failed",
          "corrupt", "buffered", "max_staleness")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_serving_loops():
    """Free the JAX serving scans this module compiles when it ends, as
    tests/test_async_engine.py does (a later compile in the same process
    segfaults otherwise)."""
    yield
    jax.clear_caches()


# tests/test_async_engine.py's two regimes: schedule-paced with occasional
# drops, and a long fixed tick that pushes the buffer over its staleness cap
_CFGS = (
    dict(n_slots=16, buffer_size=3, max_staleness=6, s_dispatch=4, n_req=8,
         arrival="poisson", arrival_rate=3.0),
    dict(n_slots=12, buffer_size=2, max_staleness=2, s_dispatch=4, n_req=8,
         tick_dt=40.0, arrival="poisson", arrival_rate=4.0),
)
_SYNC_CFG = dict(n_slots=5, buffer_size=5, max_staleness=10**6,
                 s_dispatch=5, n_req=10, tick_dt=None, arrival="full")


def _cfgs(i: int, **kw):
    """(JAX's, the port's) AsyncConfig of regime ``i``."""
    fields = {**_CFGS[i], **kw}
    return jae.AsyncConfig(**fields), ae.AsyncConfig(**fields)


# ---------------------------------------------------------------------------
# 1. the tick against JAX on JAX's draws
# ---------------------------------------------------------------------------

# (scenario, policy, regime, deadline): the five policies of the parity set,
# both regimes, the scenario multipliers (diurnal, congestion), churn and
# the failure layer
CASES = [("paper-baseline", "fedcs", 0, None),
         ("diurnal-drift", "naive_ucb", 0, None),
         ("correlated-congestion", "random", 0, None),
         ("client-churn", "elementwise_ucb", 0, None),
         ("paper-baseline", "discounted_ucb", 1, None),
         ("client-churn", "naive_ucb", 1, None),
         ("flaky-clients", "elementwise_ucb", 0, 2500.0),
         ("flaky-clients", "random", 0, 1500.0)]


@pytest.mark.parametrize("scen_name,policy,regime,deadline", CASES)
def test_tick_matches_jax_on_jax_draws(scen_name, policy, regime, deadline):
    n, k, seed = 24, 40, 3 + regime
    jcfg, cfg = _cfgs(regime, deadline=deadline)
    want = jae.serve(scen_name, policy, n_ticks=n, seed=seed, cfg=jcfg,
                     n_clients=k, eta=1.5)
    draws = jax_tick_draws(scen_name, jcfg, seed, n, k)
    got = ae.serve(scen_name, policy, n_ticks=n, seed=seed, cfg=cfg,
                   n_clients=k, eta=1.5, draws=draws, device="cpu")
    for name in TRACES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    rtol = CHURN_RTOL if scen_name == "client-churn" else RTOL
    np.testing.assert_allclose(got.dt, want.dt, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.elapsed, want.elapsed, rtol=rtol, atol=0)
    async_trees_match(got.state, want.state, rtol, f"{scen_name} {policy}")
    assert got.aggregated.sum() > 0 or regime == 1
    if deadline is not None:
        assert got.failed.sum() > 0


# ---------------------------------------------------------------------------
# 2. the degenerate reduction, on shared draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fedcs", "discounted_ucb"])
def test_degenerate_reduction_on_shared_draws(policy):
    """Each tick of a full-cohort, schedule-paced, unbounded-staleness run
    is one sync round: the same draws through the sync engine's unfused
    rounds (``run_rounds``) and ``run_replay`` give the same selections,
    round times and bandit state, bitwise."""
    n, k, seed = 8, 100, 3
    scen = scenarios.get_scenario("paper-baseline")
    cfg = ae.AsyncConfig(**_SYNC_CFG)
    env = engine.EnvArrays.from_scenario(
        scen, scen.build_env(k, np.random.default_rng(0)))
    draws = [ae.draw_tick(seed, t, k=k, cfg=cfg, scen=scen, policy=policy)
             for t in range(n)]
    res = ae.serve(scen, policy, n_ticks=n, cfg=cfg, env=env, eta=1.0,
                   draws=draws, device="cpu")

    hyper = bandit.DEFAULT_HYPERS[policy]
    eta = torch.tensor([1.0])
    rounds = [engine.RoundDraws(
        cand=bandit.cand_idx_from_mask(d.cand_mask, cfg.n_req)[None],
        u_time=d.u_time[None]) for d in draws]
    rts, _, state = engine.run_rounds(
        env, eta, rounds, policy=policy, scen=scen, s_round=5, hyper=hyper,
        model_bits=ae.PAPER_MODEL_BITS, fused=False)
    times = [engine.sample_times(env.n_samples, env.mean_theta[None],
                                 env.mean_gamma[None], eta,
                                 ae.PAPER_MODEL_BITS, d.u_time[0][None],
                                 d.u_time[1][None]) for d in draws]
    replay = engine.run_replay(
        policy, hyper, torch.stack([d.cand_mask for d in draws]),
        torch.cat([t[0] for t in times]), torch.cat([t[1] for t in times]),
        s_round=5, device="cpu")

    np.testing.assert_array_equal(res.dt, rts[0].numpy())
    np.testing.assert_array_equal(res.dt, replay["round_times"].numpy())
    np.testing.assert_array_equal(res.selected, replay["selected"].numpy())
    for s in (state, replay["state"]):
        for name, a in bandit.state_tree(res.state.bandit).items():
            np.testing.assert_array_equal(
                a.numpy(), getattr(s, name)[0].numpy(), err_msg=name)
    np.testing.assert_array_equal(res.admitted, np.full(n, 5))
    np.testing.assert_array_equal(res.aggregated, np.full(n, 5))
    assert res.dropped.sum() == 0 and res.buffered[-1] == 0
    np.testing.assert_array_equal(res.max_staleness, np.zeros(n))


# ---------------------------------------------------------------------------
# 3. serving invariants, property-based (port-only runs)
# ---------------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.sampled_from(("paper-baseline", "client-churn", "flaky-clients")),
       st.sampled_from((0, 1)),
       st.sampled_from(("elementwise_ucb", "discounted_ucb", "naive_ucb",
                        "random")))
def test_serving_invariants(seed, scenario, regime, policy):
    deadline = 3000.0 if scenario == "flaky-clients" else None
    _, cfg = _cfgs(regime, deadline=deadline)
    res = ae.serve(scenario, policy, n_ticks=30, seed=seed, cfg=cfg,
                   n_clients=40, eta=1.5, device="cpu")
    assert int(res.max_staleness.max()) <= cfg.max_staleness
    assert int(res.max_staleness.min()) >= -1
    assert res.conserved()
    assert (res.admitted <= cfg.s_dispatch).all()
    assert (res.aggregated <= cfg.buffer_size).all()
    assert (res.buffered <= cfg.n_slots).all()
    np.testing.assert_array_equal((res.selected >= 0).sum(axis=1),
                                  res.admitted)
    assert (res.dt > 0).all() and res.elapsed[0] > 0
    assert (np.diff(res.elapsed) > 0).all()
    s = res.state
    n_obs = int(res.aggregated.sum()) + int(res.failed.sum())
    assert int(s.n_aggregated) == int(res.aggregated.sum())
    assert int(s.bandit.total[0]) == n_obs
    assert int(s.bandit.n_sel.sum()) == n_obs
    assert int(s.bandit.n_fail.sum()) == int(s.n_failed)


def test_generous_deadline_matches_fault_free():
    kw = dict(n_ticks=30, seed=4, n_clients=40, device="cpu")
    base = ae.serve(**kw)
    hard = ae.serve(cfg=ae.AsyncConfig(deadline=1e9), **kw)
    for name in ("selected", "dt", "aggregated", "elapsed"):
        np.testing.assert_array_equal(getattr(base, name),
                                      getattr(hard, name), err_msg=name)
    assert torch.equal(base.state.bandit.n_sel, hard.state.bandit.n_sel)
    assert int(hard.state.n_failed) == 0


# ---------------------------------------------------------------------------
# 4. crash and resume (bitwise), through the port's checkpoint manager
# ---------------------------------------------------------------------------

def _snap_equal(a, b) -> bool:
    ta, tb = ae.snapshot_tree(a), ae.snapshot_tree(b)
    flat = lambda t: {**{k: v for k, v in t.items() if k != "bandit"},  # noqa
                      **{"bandit." + k: v for k, v in t["bandit"].items()}}
    fa, fb = flat(ta), flat(tb)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


@pytest.mark.parametrize("scen_name,policy,deadline", [
    ("diurnal-drift", "discounted_ucb", None),
    ("flaky-clients", "random", 2500.0)])
def test_crash_resume_bitwise(tmp_path, scen_name, policy, deadline):
    total, split = 24, 11
    _, cfg = _cfgs(0, deadline=deadline)
    kw = dict(seed=5, cfg=cfg, total_ticks=total, n_clients=40, eta=1.5,
              device="cpu")
    full = ae.serve(scen_name, policy, n_ticks=total, **kw)
    r1 = ae.serve(scen_name, policy, n_ticks=split, **kw)
    mgr = CheckpointManager(tmp_path)
    mgr.save(split, {"async_serve": ae.snapshot_tree(r1.state)})
    step, snap = mgr.restore()
    assert step == split
    state = ae.state_from_snapshot(snap["async_serve"], "cpu")
    assert int(state.tick) == split
    r2 = ae.serve(scen_name, policy, n_ticks=total - split, t0=split,
                  state=state, **kw)
    for name in ("dt", "selected", "elapsed", "failed"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(r1, name), getattr(r2, name)]),
            getattr(full, name), err_msg=name)
    assert _snap_equal(r2.state, full.state)


# ---------------------------------------------------------------------------
# 5. helpers and validation
# ---------------------------------------------------------------------------

def test_staleness_weights_match_jax():
    s = np.arange(-2, 300, dtype=np.int32)
    for power in (0.0, 0.5, 1.0, 0.3):
        want = np.asarray(jax.jit(lambda x, p=power: jae.staleness_weights(
            x, p))(s))
        got = ae.staleness_weights(torch.from_numpy(s), power).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_draws_are_a_function_of_seed_and_tick():
    scen = scenarios.get_scenario("flaky-clients")
    cfg = ae.AsyncConfig(deadline=2000.0)
    kw = dict(k=50, cfg=cfg, scen=scen)
    a = ae.draw_tick(7, 12, policy="random", **kw)
    b = ae.draw_tick(7, 12, policy="fedcs", **kw)
    c = ae.draw_tick(7, 13, policy="random", **kw)
    assert a.cand_mask.sum() == cfg.n_req and a.rand.shape == (50,)
    assert b.rand is None and a.fault_u.shape == (3, cfg.s_dispatch)
    for name in ("cand_mask", "u_time", "n_arr", "fault_u"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.u_time, c.u_time)
    full = ae.draw_tick(7, 12, policy="fedcs", k=50, scen=scen,
                        cfg=dataclasses.replace(cfg, arrival="full"))
    assert int(full.n_arr) == cfg.s_dispatch
    assert ae.arrival_rate(scenarios.get_scenario("diurnal-drift"), cfg,
                           49) == pytest.approx(5.0 * 1.5)


def test_config_and_segment_validation():
    with pytest.raises(ValueError, match="must fit"):
        ae.AsyncConfig(n_slots=2, s_dispatch=5)
    with pytest.raises(ValueError, match="buffer_size"):
        ae.AsyncConfig(buffer_size=0)
    with pytest.raises(ValueError, match="max_staleness"):
        ae.AsyncConfig(max_staleness=-1)
    with pytest.raises(ValueError, match="tick_dt"):
        ae.AsyncConfig(tick_dt=0.0)
    with pytest.raises(ValueError, match="idle_dt"):
        ae.AsyncConfig(idle_dt=-1.0)
    with pytest.raises(ValueError, match="arrival"):
        ae.AsyncConfig(arrival="bursty")
    with pytest.raises(ValueError, match="backoff"):
        ae.AsyncConfig(backoff_base=0.0)
    assert [f.name for f in dataclasses.fields(ae.AsyncConfig)] == [
        f.name for f in dataclasses.fields(jae.AsyncConfig)]
    assert dataclasses.asdict(ae.AsyncConfig()) == dataclasses.asdict(
        jae.AsyncConfig())
    with pytest.raises(ValueError, match="outside"):
        ae.serve(n_ticks=5, t0=8, total_ticks=10, device="cpu")
    with pytest.raises(ValueError, match="resumed state"):
        ae.serve(n_ticks=5, t0=3, total_ticks=8, device="cpu")
    with pytest.raises(ValueError, match="deadline"):
        ae.serve("flaky-clients", n_ticks=2, device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        ae.serve(policy="nope", n_ticks=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ae.serve(n_ticks=2)


def test_snapshot_round_trips_every_field():
    scen = scenarios.get_scenario("paper-baseline")
    res = ae.serve(scen, "discounted_ucb", n_ticks=10, n_clients=20,
                   device="cpu")
    tree = ae.snapshot_tree(res.state)
    assert set(tree) == {f.name for f in dataclasses.fields(ae.AsyncState)}
    assert tree["bandit"]["n_sel"].shape == (20,)
    assert tree["now"].dtype == torch.float32 and tree["tick"].dim() == 0
    back = ae.state_from_snapshot({k: (v if k != "bandit" else
                                       {n: x.numpy() for n, x in v.items()})
                                   for k, v in tree.items()}, "cpu")
    assert _snap_equal(back, res.state)
