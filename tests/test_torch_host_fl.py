"""The port's host-loop FL server and its numpy modules against the JAX
package's, bitwise: ``core/host_bandit.py`` (Eq. (1), ``ClientStats``,
Algorithm 1, the six policies, ``make_policy``), ``core/nonstationary.py``,
``sim/resources.ResourceModel``, ``sim/scenarios.ScenarioResources``,
``fl/server.FederatedServer`` (time-only, 30 rounds: every policy, every
scenario, a failure mask, a deadline, ``forget``) and
``data/synthetic.make_token_stream``.  Both sides are numpy on the same
``default_rng`` draws, so every comparison is exact (tolerance 0).
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import bandit as jb
from repro.core import nonstationary as jns
from repro.data import synthetic as jsyn
from repro.fl import server as jsrv
from repro.sim import network as jnet
from repro.sim import resources as jres
from repro.sim import scenarios as jscen
from repro_torch.core import host_bandit as tb
from repro_torch.core import nonstationary as tns
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import server as tsrv
from repro_torch.sim import network as tnet
from repro_torch.sim import resources as tres
from repro_torch.sim import scenarios as tscen
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

POLICIES = ("fedcs", "extended_fedcs", "naive_ucb", "elementwise_ucb",
            "random", "oracle", "discounted_ucb", "sliding_ucb")
SCENARIOS = tuple(jscen.SCENARIOS)
STATS_FIELDS = ("n_sel", "sum_ud", "sum_ul", "sum_tinc", "last_ud",
                "last_ul", "hist_ud", "hist_ul", "hist_n", "total_sel")


def _stats_equal(a, b):
    for f in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _fed(stats_j, stats_t, rng, k, rounds=12):
    """The same observations and forgets into both ClientStats."""
    for _ in range(rounds):
        for c in rng.choice(k, 5, replace=False):
            ud, ul, inc = rng.uniform(1, 300, 3)
            stats_j.observe(int(c), ud, ul, inc)
            stats_t.observe(int(c), ud, ul, inc)
        if rng.uniform() < 0.3:
            c = int(rng.integers(k))
            stats_j.forget(c)
            stats_t.forget(c)


def test_policy_registry_matches():
    jb.make_policy("discounted_ucb", 4, 2)       # registers the lazy ones
    tb.make_policy("discounted_ucb", 4, 2)
    assert sorted(tb.POLICIES) == sorted(jb.POLICIES) == sorted(POLICIES)
    with pytest.raises(ValueError):
        tb.make_policy("nope", 4, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eq1_and_round_times_bitwise(seed):
    rng = np.random.default_rng(seed)
    t_ud, t_ul = rng.uniform(1, 500, (2, 30))
    for _ in range(20):
        order = [int(x) for x in rng.choice(30, rng.integers(0, 8),
                                            replace=False)]
        assert tb.estimate_round_time(order, t_ud, t_ul) == \
            jb.estimate_round_time(order, t_ud, t_ul)
        assert tb.true_round_time(order, t_ud, t_ul) == \
            jb.true_round_time(order, t_ud, t_ul)
    args = rng.uniform(0, 100, 4)
    assert tb.t_inc(*args) == jb.t_inc(*args)


@pytest.mark.parametrize("window", [3, 5])
def test_client_stats_bitwise(window):
    rng = np.random.default_rng(window)
    sj, st = jb.ClientStats.create(40, window), tb.ClientStats.create(
        40, window)
    _fed(sj, st, rng, 40)
    _stats_equal(sj, st)
    for name in ("mean_ud", "mean_ul", "mean_tinc", "ucb_bonus"):
        np.testing.assert_array_equal(getattr(st, name)(),
                                      getattr(sj, name)(), err_msg=name)
    for a, b in zip(st.moving_avg(), sj.moving_avg()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_select_bitwise(naive, seed):
    rng = np.random.default_rng(seed)
    cand = np.sort(rng.choice(50, 12, replace=False))
    ud, ul = rng.uniform(-5, 300, (2, 50))
    extra = rng.uniform(-1, 1, 50) if naive else None
    for s in (1, 5, 12, 20):
        assert tb.greedy_select(cand, s, ud, ul, extra) == \
            jb.greedy_select(cand, s, ud, ul, extra)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_select_bitwise(policy):
    """Each policy on the same mid-run statistics and generator state
    (the discounted one after the same round observations)."""
    k = 60
    rng = np.random.default_rng(7)
    sj, st = jb.ClientStats.create(k), tb.ClientStats.create(k)
    _fed(sj, st, rng, k)
    pj, pt = jb.make_policy(policy, k, 5), tb.make_policy(policy, k, 5)
    assert type(pt).__name__ == type(pj).__name__
    times = rng.uniform(1, 400, (2, k))
    for _ in range(4):
        sel = [int(x) for x in rng.choice(k, 5, replace=False)]
        if hasattr(pj, "observe_round"):
            pj.observe_round(sel, *times)
            pt.observe_round(sel, *times)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        cand = np.sort(rng.choice(k, 10, replace=False))
        assert pt.select(st, cand, rt, true_times=tuple(times)) == \
            pj.select(sj, cand, rj, true_times=tuple(times))


def test_discounted_stats_bitwise():
    dj, dt = jns.DiscountedStats(30, 0.9), tns.DiscountedStats(30, 0.9)
    rng = np.random.default_rng(0)
    for _ in range(25):
        sel = [int(x) for x in rng.choice(30, 4, replace=False)]
        t_ud, t_ul = rng.uniform(1, 300, (2, 30))
        dj.observe_round(sel, t_ud, t_ul)
        dt.observe_round(sel, t_ud, t_ul)
    for name in ("n", "sum_ud", "sum_ul"):
        np.testing.assert_array_equal(getattr(dt, name), getattr(dj, name))
    assert dt.total == dj.total
    np.testing.assert_array_equal(dt.bonus(), dj.bonus())


def _envs(k=50, seed=0):
    return (jnet.make_network_env(k, np.random.default_rng(seed)),
            tnet.make_network_env(k, np.random.default_rng(seed)))


def test_drifting_resources_bitwise():
    ej, et = _envs()
    dj = jns.DriftingResources(ej, 1.5, jres.PAPER_MODEL_BITS, seed=4)
    dt = tns.DriftingResources(et, 1.5, tres.PAPER_MODEL_BITS, seed=4)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(10):
        dj.advance()
        dt.advance()
        for a, b in zip(dt.sample_times(rt), dj.sample_times(rj)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fluctuate", [True, False])
@pytest.mark.parametrize("eta", [-2.0, 1.5, 1.99])
def test_resource_model_bitwise(fluctuate, eta):
    assert tres.PAPER_MODEL_BITS == jres.PAPER_MODEL_BITS
    ej, et = _envs()
    mj = jres.ResourceModel(ej, eta, jres.PAPER_MODEL_BITS, fluctuate)
    mt = tres.ResourceModel(et, eta, tres.PAPER_MODEL_BITS, fluctuate)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(5):
        for a, b in zip(mt.sample_times(rt), mj.sample_times(rj)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(mt.mean_times(), mj.mean_times()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scen", SCENARIOS)
def test_scenario_resources_bitwise(scen):
    sj, st = jscen.SCENARIOS[scen], tscen.SCENARIOS[scen]
    ej = sj.build_env(40, np.random.default_rng(2))
    et = st.build_env(40, np.random.default_rng(2))
    xj = jscen.ScenarioResources(sj, ej, seed=3)
    xt = tscen.ScenarioResources(st, et, seed=3)
    rj, rt = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(30):
        xj.advance()
        xt.advance()
        for a, b in zip(xt.sample_times(rt), xj.sample_times(rj)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(xt.mean_theta, xj.mean_theta)
    np.testing.assert_array_equal(xt.mean_gamma, xj.mean_gamma)


def _server_pair(policy="elementwise_ucb", scen=None, k=50, s=5, seed=0,
                 deadline=math.inf):
    out = []
    for m, net, res, scn in ((jsrv, jnet, jres, jscen), (tsrv, tnet, tres,
                                                          tscen)):
        bandit = jb if m is jsrv else tb
        if scen is None:
            env = net.make_network_env(k, np.random.default_rng(seed))
            rm = res.ResourceModel(env, 1.5, res.PAPER_MODEL_BITS)
        else:
            sc = scn.SCENARIOS[scen]
            env = sc.build_env(k, np.random.default_rng(seed))
            rm = scn.ScenarioResources(sc, env, seed=seed)
        out.append(m.FederatedServer(
            m.FLConfig(n_clients=k, s_round=s, seed=seed,
                       deadline_s=deadline),
            bandit.make_policy(policy, k, s), rm))
    return out


def _records_equal(sj, st):
    assert len(st.history) == len(sj.history)
    for a, b in zip(st.history, sj.history):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert st.elapsed == sj.elapsed
    assert st.failed_rounds == sj.failed_rounds
    _stats_equal(sj.stats, st.stats)


@pytest.mark.parametrize("policy", POLICIES)
def test_server_time_only_bitwise(policy):
    sj, st = _server_pair(policy)
    sj.run(30)
    st.run(30)
    _records_equal(sj, st)


@pytest.mark.parametrize("scen", SCENARIOS)
def test_server_scenarios_bitwise(scen):
    """Every scenario through ScenarioResources, as tests/test_sim.py
    plugs them into the JAX package's server."""
    sj, st = _server_pair("elementwise_ucb", scen, k=20, s=3)
    sj.run(30)
    st.run(30)
    _records_equal(sj, st)


@pytest.mark.parametrize("deadline", [math.inf, 900.0])
def test_server_failures_bitwise(deadline):
    """A failure mask each round (``run(failure_prob=)``), with and without
    a deadline."""
    sj, st = _server_pair("naive_ucb", deadline=deadline)
    sj.run(30, failure_prob=0.3)
    st.run(30, failure_prob=0.3)
    _records_equal(sj, st)


def test_server_deadline_and_forget_bitwise():
    """A deadline that drops clients, and arms reset mid-run (the elastic
    swap of launch/train.py)."""
    sj, st = _server_pair("elementwise_ucb", deadline=1500.0)
    for r in range(30):
        sj.run_round(r)
        st.run_round(r)
        if r % 4 == 3:
            kj = int(sj.rng.integers(0, 50))
            kt = int(st.rng.integers(0, 50))
            assert kj == kt
            sj.stats.forget(kj)
            st.stats.forget(kt)
    _records_equal(sj, st)
    assert sj.failed_rounds > 0 or any(
        r.round_time == 1500.0 for r in sj.history)


@pytest.mark.parametrize("n,vocab,seed", [(5000, 512, 0), (3000, 6000, 1),
                                          (20_000, 49152, 2)])
def test_make_token_stream_bitwise(n, vocab, seed):
    a = tsyn.make_token_stream(n, vocab, seed=seed)
    b = jsyn.make_token_stream(n, vocab, seed=seed)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
