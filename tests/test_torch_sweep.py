"""The port's sweep engine (repro_torch.sim.engine) against the JAX
package's ``sim.engine_jax``, on the CPU.

  1. ``run_replay`` against ``engine_jax.run_replay`` on the same
     presampled candidates and times: selections exact;
  2. the round runner (``run_rounds``) against a loop over the JAX
     package's round functions, both fed the same numpy draws (the replay
     seam), fused and unfused, legacy and streamed sampling, for
     paper-baseline, correlated-congestion and flaky-clients;
  3. ``sweep(device="cpu")`` end to end, with the fault-count
     conservation, the draw step's contract and the entry points' refusals.

Tolerances: round times within rtol 1e-6 per round and 1e-5 on the
cumulative elapsed time (XLA sums the cumulative total in its own order);
Eq. (8) draws and UCB bonuses carry last-ulp differences of XLA's vs
PyTorch's transcendentals.  Selections, flags and counts are exact.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_states_match, jax_tree,  # noqa: E402
                           sorted_candidates)

from repro.core import bandit_jax  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.sim import engine_jax  # noqa: E402
from repro.sim import truncnorm as jtruncnorm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
from repro_torch.sim.truncnorm import truncnorm_transform_np  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

DETERMINISTIC = [p for p in bandit.POLICY_NAMES if p != "random"]
BITS = np.float32(146.4e6)


# ---------------------------------------------------------------------------
# 1. run_replay
# ---------------------------------------------------------------------------

def _replay_inputs(k=100, rounds=50, n_req=10, eta=1.5, seed=0):
    rng = np.random.default_rng(seed)
    env = scenarios.get_scenario("paper-baseline").build_env(k, rng)
    masks = np.zeros((rounds, k), bool)
    t_ud = np.zeros((rounds, k), np.float32)
    t_ul = np.zeros((rounds, k), np.float32)
    for r in range(rounds):
        masks[r, rng.choice(k, n_req, replace=False)] = True
        theta = truncnorm_transform_np(rng.random(k),
                                       env.mean_throughput_bps, eta)
        gamma = truncnorm_transform_np(rng.random(k), env.mean_capability,
                                       eta)
        t_ud[r], t_ul[r] = env.n_samples / gamma, BITS / theta
    return masks, t_ud, t_ul


@functools.cache
def _jax_replay():
    masks, t_ud, t_ul = _replay_inputs()
    out = {}
    for p in DETERMINISTIC:
        res = engine_jax.run_replay(
            jnp.int32(bandit_jax.POLICY_IDS[p]),
            jnp.float32(bandit_jax.DEFAULT_HYPERS[p]), jnp.asarray(masks),
            jnp.asarray(t_ud), jnp.asarray(t_ul), jax.random.PRNGKey(0),
            s_round=5)
        out[p] = {k: np.asarray(v) for k, v in res.items() if k != "state"}
    return out


@pytest.mark.parametrize("policy", DETERMINISTIC)
def test_run_replay_matches_jax(policy):
    masks, t_ud, t_ul = _replay_inputs()
    got = engine.run_replay(policy, bandit.DEFAULT_HYPERS[policy], masks,
                            t_ud, t_ul, s_round=5, device="cpu")
    want = _jax_replay()[policy]
    np.testing.assert_array_equal(got["selected"].numpy(), want["selected"])
    np.testing.assert_allclose(got["round_times"].numpy(),
                               want["round_times"], rtol=1e-6)
    np.testing.assert_allclose(got["elapsed"].numpy(), want["elapsed"],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# 2. the round runner against a JAX loop on the same draws
# ---------------------------------------------------------------------------

K, C, S, G, R = 60, 15, 4, 2, 12
ETAS = np.array([1.5, 1.9], np.float32)
DEADLINE = 400.0
# (scenario, fused, fast) cases; the policy rotates so every policy runs
CASES = [(scen, fused, fast)
         for scen in ("paper-baseline", "correlated-congestion",
                      "flaky-clients")
         for fused in (True, False) for fast in (False, True)]
CASES = [(*case, bandit.POLICY_NAMES[i % 8]) for i, case in enumerate(CASES)]


def _numpy_draws(scen, policy, fast, seed):
    rng = np.random.default_rng(seed)
    n = C if fast else K
    draws = []
    for _ in range(R):
        draws.append(dict(
            cand=sorted_candidates(rng, G, K, C),
            u_time=rng.random((G, 2, n), np.float32),
            rand=(rng.random((G, K), np.float32) if policy == "random"
                  else None),
            fault_u=(rng.random((G, 3, S), np.float32)
                     if scen.fault.active else None),
            cong=(rng.standard_normal((G, scen.congestion_cells)).astype(
                np.float32) if scen.congestion_cells else None)))
    return draws


@functools.cache
def _jax_step(scen_name, policy, fused, fast):
    """One grid point's round of the JAX package, from given draws: the
    scenario multiplier, the Eq. (8) draws, then the fused round
    (``use_kernel=False``) or the unfused mask pipeline."""
    scen = scenarios.get_scenario(scen_name)
    deadline = DEADLINE if scen.fault.active else None
    fault = bandit_jax.resolve_fault(scen.fault.probs, deadline)
    kw = dict(policy=policy, s_round=S, decay=bandit_jax.policy_decay(policy),
              fault=fault, deadline=deadline)
    hyper = jnp.float32(bandit_jax.DEFAULT_HYPERS[policy])

    def step(state, env, d, eta):
        mu_t = env["mean_theta"]
        if d["cong"] is not None:
            mu_t = mu_t * jnp.exp(scen.congestion_sigma
                                  * d["cong"])[env["cell_id"]]
        cand, fu = d["cand"], d["fault_u"]
        if fast and fused:
            return jops.bandit_round_sampled(
                state, cand, d["u_time"], d["rand"], mu_t, env["mean_gamma"],
                env["n_samples"], eta, BITS, hyper, use_kernel=False,
                fault_u=fu, **kw)
        if fast:
            safe = jnp.where(cand < K, cand, 0)
            tu, tl = jref.truncnorm_times_ref(
                d["u_time"], mu_t[safe], env["mean_gamma"][safe],
                env["n_samples"][safe], eta, BITS)
            t_ud, t_ul, mask = bandit_jax.scatter_cand_times(cand, tu, tl, K)
        else:
            theta = jtruncnorm.truncnorm_transform(d["u_time"][0], mu_t, eta)
            gamma = jtruncnorm.truncnorm_transform(d["u_time"][1],
                                                   env["mean_gamma"], eta)
            t_ud, t_ul = engine_jax.sample_times(
                env["n_samples"], theta, gamma, eta, BITS, None, None,
                fluctuate=False)
            if fused:
                return jops.bandit_round(state, cand, t_ud, t_ul, d["rand"],
                                         hyper, use_kernel=False, fault_u=fu,
                                         **kw)
            mask = jnp.zeros(K, bool).at[cand].set(True)
        return bandit_jax.round_via_mask(state, mask, t_ud, t_ul, d["rand"],
                                         hyper, fault_u=fu, **kw)
    return jax.jit(step)


@pytest.mark.parametrize("scen_name,fused,fast,policy", CASES)
def test_round_runner_matches_jax_loop(scen_name, fused, fast, policy):
    scen = scenarios.get_scenario(scen_name)
    deadline = DEADLINE if scen.fault.active else None
    env_np = scen.build_env(K, np.random.default_rng(1))
    env = engine.EnvArrays.from_scenario(scen, env_np)
    draws = _numpy_draws(scen, policy, fast, seed=len(scen_name) + 2 * fast)
    t = lambda x: None if x is None else torch.from_numpy(x)
    rts, flags, state = engine.run_rounds(
        env, torch.from_numpy(ETAS),
        [engine.RoundDraws(**{k: t(v) for k, v in d.items()})
         for d in draws],
        policy=policy, scen=scen, s_round=S,
        hyper=bandit.DEFAULT_HYPERS[policy], model_bits=float(BITS),
        fast=fast, fused=fused, deadline=deadline)

    jenv = {k: jnp.asarray(v) for k, v in convert.env_tree(env).items()}
    step = _jax_step(scen_name, policy, fused, fast)
    want_states = []
    for g in range(G):
        st = bandit_jax.BanditState.create(K)
        for r, d in enumerate(draws):
            jd = {k: None if v is None else jnp.asarray(v[g])
                  for k, v in d.items()}
            out = step(st, jenv, jd, jnp.float32(ETAS[g]))
            st = out[0]
            where = f"{policy} round {r} grid point {g}"
            np.testing.assert_allclose(float(rts[g, r]), float(out[2]),
                                       rtol=1e-6, err_msg=where)
            if deadline is not None:
                np.testing.assert_array_equal(flags[g, r].numpy(),
                                              np.asarray(out[3]), where)
        want_states.append(jax_tree(st))
    assert flags is None or deadline is not None
    assert_states_match(convert.state_tree(state), want_states, 1e-6, policy)


# ---------------------------------------------------------------------------
# 3. sweep end to end, the draw step, refusals
# ---------------------------------------------------------------------------

def test_sweep_cpu_end_to_end_and_fault_conservation():
    res = engine.sweep("flaky-clients", policies=("elementwise_ucb",
                                                  ("naive_ucb", 500.0),
                                                  "random"),
                       etas=(1.0, 1.9), seeds=2, n_rounds=15, n_clients=40,
                       frac_request=0.25, deadline=DEADLINE, device="cpu")
    assert res.round_times.shape == (3, 2, 2, 15)
    assert res.flags.shape == (3, 2, 2, 15, 5)
    assert np.all(np.isfinite(res.round_times)) and np.all(
        res.round_times > 0)
    assert np.all(res.round_times <= np.float32(DEADLINE))
    fc = res.fault_counts()
    parts = sum(fc[k] for k in ("ok", "crashed", "churned",
                                "deadline_missed", "corrupt"))
    np.testing.assert_array_equal(parts, fc["dispatched"])
    assert fc["dispatched"].min() == 15 * 5
    assert res.hypers == (50.0, 500.0, 0.0)
    assert res.mean_elapsed().shape == (3, 2)


def test_sweep_streamed_path_and_unfused_agree():
    """The fused and unfused rounds run the same draws to the same result;
    the streamed path is the default at K >= 1024."""
    kw = dict(policies=("fedcs", "discounted_ucb"), etas=(1.5,), seeds=2,
              n_rounds=6, n_clients=1024, frac_request=0.02, device="cpu")
    a = engine.sweep("correlated-congestion", **kw)
    b = engine.sweep("correlated-congestion", fused=False, **kw)
    np.testing.assert_allclose(a.round_times, b.round_times, rtol=1e-6)
    assert engine.resolve_fast_sampling(None, 1024)
    assert not engine.resolve_fast_sampling(None, 100)


def test_draw_round_inputs_contract():
    scen = scenarios.get_scenario("flaky-clients")
    gens = engine.make_generators((0, 1, 2), "cpu")
    for fast in (False, True):
        d = engine.draw_round_inputs(
            gens, n_seeds=3, n_etas=2, k=50, n_req=7, s_round=4, fast=fast,
            fluctuate=True, policy="random", scen=scen,
            fault=scen.fault.probs)
        assert d.cand.shape == (6, 7) and d.cand.dtype == torch.int32
        assert torch.all(d.cand[:, 1:] > d.cand[:, :-1])   # sorted, unique
        assert d.u_time.shape == (6, 2, 7 if fast else 50)
        assert d.rand.shape == (6, 50) and d.fault_u.shape == (6, 3, 4)
        assert d.cong is None and d.churn is None
        # every eta of one seed sees the same draws
        torch.testing.assert_close(d.cand[:3], d.cand[3:])
        torch.testing.assert_close(d.u_time[:3], d.u_time[3:])
    # the same seeds give the same streams
    a = engine.draw_round_inputs(
        engine.make_generators((0, 1, 2), "cpu"), n_seeds=3, n_etas=1, k=50,
        n_req=7, s_round=4, fast=True, fluctuate=True, policy="fedcs",
        scen=scen, fault=None)
    b = engine.draw_round_inputs(
        engine.make_generators((0, 1, 2), "cpu"), n_seeds=3, n_etas=1, k=50,
        n_req=7, s_round=4, fast=True, fluctuate=True, policy="random",
        scen=scen, fault=None)
    torch.testing.assert_close(a.cand, b.cand)
    torch.testing.assert_close(a.u_time, b.u_time)


def test_sweep_churn_scenario_runs():
    res = engine.sweep("client-churn", policies=("sliding_ucb",), seeds=2,
                       etas=(1.5,), n_rounds=10, n_clients=30,
                       frac_request=0.3, device="cpu")
    assert np.all(np.isfinite(res.round_times))
    k = 30
    u = torch.tensor([[0.0, 0.5, 0.25, 0.5], [0.99, 0.1, 0.5, 0.5]])
    theta = torch.ones(2, k)
    new_t, new_g = engine.churn_step(u, theta, theta.clone(), 0.2)
    assert (new_t != 1).sum() == 1 and new_t[0, 15] != 1
    assert new_g[0, 15] == scenarios.CAP_LOW + 0.5 * (
        scenarios.CAP_HIGH - scenarios.CAP_LOW)


def test_entry_points_refuse_what_is_not_ported():
    """What the sweep refuses: a ``chunk_rounds`` that does not divide
    ``n_rounds`` (the JAX package's ValueError), a ``devices`` that is no
    number of shards, a fault scenario without a deadline and an unknown
    policy.  (``devices`` that do not split over the ranks of a process
    group are refused in tests/test_torch_distributed.py.)"""
    kw = dict(n_rounds=2, seeds=1, device="cpu")
    with pytest.raises(ValueError, match="n_rounds=2 not divisible by "
                                         "chunk_rounds=3"):
        engine.sweep(**kw, chunk_rounds=3)
    for bad in ("two", -1, 2.0, True):
        with pytest.raises(ValueError, match="devices"):
            engine.sweep(**kw, devices=bad)
    with pytest.raises(ValueError, match="deadline"):
        engine.sweep("flaky-clients", **kw)
    with pytest.raises(ValueError, match="unknown policy"):
        engine.sweep(policies=("nope",), **kw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert engine.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.sweep(n_rounds=1, seeds=1)
    assert engine.resolve_device("cpu").type == "cpu"
