"""The port's bandit round steps (repro_torch.core.bandit, plain PyTorch on
the CPU) against the JAX package's ``core.bandit_jax`` on the same mid-run
state, carried across through repro_torch.convert.

Selections, flags and integer leaves must match exactly.  Float outputs are
held to rtol 1e-6: XLA's and PyTorch's log and sqrt may differ in the last
ulp (the UCB bonus), and XLA may contract a multiply-add that PyTorch
rounds twice (the gamma decay).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_states_match, jax_tree,  # noqa: E402
                           mid_run_tree, stack_trees)

from repro.core import bandit_jax  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

K, G, S = 64, 3, 5
RTOL = 1e-6


def _states(seed=0):
    rng = np.random.default_rng(seed)
    trees = [mid_run_tree(rng, K) for _ in range(G)]
    return ([bandit_jax.state_from_tree(t) for t in trees],
            bandit.state_from_tree(stack_trees(trees)), rng)


def test_convert_round_trip():
    jstates, pstate, _ = _states()
    back = convert.state_tree(pstate)
    for g, js in enumerate(jstates):
        for name, want in jax_tree(js).items():
            np.testing.assert_array_equal(back[name][g], want, name)
            assert back[name].dtype == want.dtype, name
    one = bandit.state_from_tree(jax_tree(jstates[1]))
    assert one.n_sel.shape == (1, K) and one.total.shape == (1,)
    single = convert.state_tree(one, batched=False)
    np.testing.assert_array_equal(single["hist_ud"],
                                  np.asarray(jstates[1].hist_ud))
    with pytest.raises(ValueError, match="G=1"):
        convert.state_tree(pstate, batched=False)


def test_convert_env_round_trip():
    from repro.sim import engine_jax
    from repro.sim.scenarios import get_scenario
    scen = get_scenario("correlated-congestion")
    env = scen.build_env(K, np.random.default_rng(2))
    want = engine_jax.EnvArrays.from_scenario(scen, env)
    tree = {f: np.asarray(getattr(want, f)) for f in
            ("mean_theta", "mean_gamma", "n_samples", "cell_id")}
    back = convert.env_tree(convert.env_from_tree(tree))
    for name, x in tree.items():
        np.testing.assert_array_equal(back[name], x, name)
        assert back[name].dtype == x.dtype, name


@pytest.mark.parametrize("policy", bandit.POLICY_NAMES)
def test_policy_scores_match(policy):
    jstates, pstate, rng = _states(1)
    t_ud = rng.uniform(1, 60, (G, K)).astype(np.float32)
    t_ul = rng.uniform(5, 200, (G, K)).astype(np.float32)
    rand = rng.random((G, K), np.float32)
    hyper = bandit.DEFAULT_HYPERS[policy]
    kind, a, b = bandit.policy_scores(
        policy, bandit.state_obs(pstate), pstate.total, pstate.disc_total,
        torch.from_numpy(t_ud), torch.from_numpy(t_ul),
        torch.from_numpy(rand), hyper)
    assert kind == bandit.policy_kind(policy)
    for g, js in enumerate(jstates):
        jkind, ja, jb = bandit_jax.policy_scores(
            policy, bandit_jax.state_obs(js), js.total, js.disc_total,
            jnp.asarray(t_ud[g]), jnp.asarray(t_ul[g]), jnp.asarray(rand[g]),
            jnp.float32(hyper))
        assert jkind == kind
        np.testing.assert_allclose(a[g].numpy(), np.asarray(ja), rtol=RTOL)
        if jb is not None:
            np.testing.assert_allclose(b[g].numpy(), np.asarray(jb),
                                       rtol=RTOL)


def _tied_estimates(rng, n):
    """Estimates drawn from a handful of values (forced ties), some at the
    -BIG cold-start sentinel."""
    vals = np.array([-1e12, 3.0, 7.0, 7.5, 20.0], np.float32)
    return vals[rng.integers(0, len(vals), (G, n))]


@pytest.mark.parametrize("n_valid", [0, 3, 9, 40])
def test_selection_with_ties_and_exhausted_masks(n_valid):
    rng = np.random.default_rng(n_valid)
    n = 40
    est_ud, est_ul = _tied_estimates(rng, n), _tied_estimates(rng, n)
    valid = np.zeros((G, n), bool)
    for g in range(G):
        valid[g, rng.choice(n, n_valid, replace=False)] = True
    t = torch.from_numpy
    greedy = bandit.greedy_slots(t(est_ud), t(est_ul), t(valid), S).numpy()
    top = bandit.top_slots(t(est_ud), t(valid), S).numpy()
    for g in range(G):
        np.testing.assert_array_equal(greedy[g], np.asarray(
            bandit_jax.greedy_slots(jnp.asarray(est_ud[g]),
                                    jnp.asarray(est_ul[g]),
                                    jnp.asarray(valid[g]), S)))
        np.testing.assert_array_equal(top[g], np.asarray(
            bandit_jax.top_slots(jnp.asarray(est_ud[g]),
                                 jnp.asarray(valid[g]), S)))
    assert (greedy == -1).sum() == G * max(S - n_valid, 0)


def _slot_inputs(rng):
    valid = rng.random((G, S)) < 0.75
    ud = rng.uniform(1, 60, (G, S)).astype(np.float32)
    ul = rng.uniform(5, 200, (G, S)).astype(np.float32)
    return valid, ud, ul


def test_schedule_completions_match():
    """Adds and maxima in one order on both sides: expected bitwise; the
    tolerance only guards an XLA reassociation."""
    valid, ud, ul = _slot_inputs(np.random.default_rng(2))
    t = torch.from_numpy
    rt, incs, fin = bandit.schedule_completions(t(valid), t(ud), t(ul))
    for g in range(G):
        jrt, jincs, jfin = bandit_jax.schedule_completions(
            jnp.asarray(valid[g]), jnp.asarray(ud[g]), jnp.asarray(ul[g]))
        np.testing.assert_allclose(float(rt[g]), float(jrt), rtol=RTOL)
        np.testing.assert_allclose(incs[g].numpy(), np.asarray(jincs),
                                   rtol=RTOL)
        np.testing.assert_allclose(fin[g].numpy(), np.asarray(jfin),
                                   rtol=RTOL)
    sel = np.where(valid, rng_sel(valid.shape), -1).astype(np.int32)
    t_ud = np.random.default_rng(9).uniform(1, 60, (G, K)).astype(np.float32)
    t_ul = np.random.default_rng(8).uniform(5, 200, (G, K)).astype(
        np.float32)
    rt, incs = bandit.schedule_selected(t(sel), t(t_ud), t(t_ul))
    for g in range(G):
        jrt, jincs = bandit_jax.schedule_selected(
            jnp.asarray(sel[g]), jnp.asarray(t_ud[g]), jnp.asarray(t_ul[g]))
        np.testing.assert_allclose(float(rt[g]), float(jrt), rtol=RTOL)
        np.testing.assert_allclose(incs[g].numpy(), np.asarray(jincs),
                                   rtol=RTOL)


def rng_sel(shape):
    """Distinct client indices per row."""
    rng = np.random.default_rng(7)
    return np.stack([rng.choice(K, shape[1], replace=False)
                     for _ in range(shape[0])])


@pytest.mark.parametrize("fault", [None, (0.3, 0.2, 0.2)])
def test_censor_slots_match(fault):
    rng = np.random.default_rng(4)
    valid, ud, ul = _slot_inputs(rng)
    t = torch.from_numpy
    rt, incs, fin = bandit.schedule_completions(t(valid), t(ud), t(ul))
    fu = rng.random((G, 3, S), np.float32)
    deadline = float(np.median(fin.numpy()))
    got = bandit.censor_slots(t(valid), t(ud), t(ul), incs, fin, rt, t(fu),
                              fault, deadline)
    for g in range(G):
        want = bandit_jax.censor_slots(
            jnp.asarray(valid[g]), jnp.asarray(ud[g]), jnp.asarray(ul[g]),
            jnp.asarray(incs[g].numpy()), jnp.asarray(fin[g].numpy()),
            jnp.float32(rt[g]), jnp.asarray(fu[g]), fault, deadline)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(
                x[g].numpy(), np.asarray(y).astype(x.numpy().dtype))


@pytest.mark.parametrize("decay,with_fail", [(1.0, False), (0.99, True)])
def test_observe_matches(decay, with_fail):
    jstates, pstate, rng = _states(5)
    idx = np.stack([np.concatenate([rng.choice(K, 3, replace=False),
                                    [-1, -1]]) for _ in range(G)])
    idx[0, :] = [-1, -1, -1, -1, -1]      # an all-padding row
    idx = idx.astype(np.int32)
    ud, ul, inc = (rng.uniform(1, 300, (G, S)).astype(np.float32)
                   for _ in range(3))
    fail = rng.random((G, S)) < 0.5 if with_fail else None
    t = torch.from_numpy
    new = bandit.observe(pstate, t(idx), t(ud), t(ul), t(inc), decay=decay,
                         fail=None if fail is None else t(fail))
    want = [jax_tree(bandit_jax.observe(
        js, jnp.asarray(idx[g]), jnp.asarray(ud[g]), jnp.asarray(ul[g]),
        jnp.asarray(inc[g]), decay=decay,
        fail=None if fail is None else jnp.asarray(fail[g])))
        for g, js in enumerate(jstates)]
    assert_states_match(convert.state_tree(new), want, RTOL)


def test_resolve_fault_rules():
    assert bandit.resolve_fault(None, None) is None
    assert bandit.resolve_fault((0.0, 0.0, 0.0), 10.0) is None
    assert bandit.resolve_fault((0.1, 0.0, 0.0), 10.0) == (0.1, 0.0, 0.0)
    with pytest.raises(ValueError, match="deadline"):
        bandit.resolve_fault((0.1, 0.0, 0.0), None)
    with pytest.raises(ValueError, match="positive"):
        bandit.resolve_fault(None, -1.0)
