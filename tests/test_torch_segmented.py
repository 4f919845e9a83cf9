"""The port's client-sharded (segmented) rounds against the JAX package, on
the CPU.

  1. ``kernels/ref.local_topk_ref`` and ``segmented_topk_ref`` against the
     JAX package's (and its ``topk_slots_pallas`` in interpret mode) on
     tie-heavy scores, -inf entries, all-invalid rows and S past the valid
     count;
  2. ``core/bandit.make_segmented_round_fn`` against the JAX
     ``make_segmented_round_fn`` run under ``jax.vmap`` over P blocks with
     a named axis (``psum``, ``all_gather`` and ``axis_index`` act on the
     vmapped axis), for all 8 policies, P in {1, 2, 4}, failure layer off
     and on; and against the port's own flat round;
  3. ``sweep(shard="clients", devices=P)`` against the flat ``sweep``;
  4. the candidate draw's tie rule (``engine.topk_lowest``) against
     ``lax.top_k`` where ``torch.topk`` differs.

Tolerances: selections, slots, flags and integer state exact; round times
and float state within rtol 1e-6 against JAX (XLA contracts multiply-adds,
ROADMAP Queue 3); the port's segmented path against its flat path bitwise.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_states_match, jax_tree,  # noqa: E402
                           mid_run_tree, sorted_candidates, stack_trees)

from repro.core import bandit_jax  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bandit_round import topk_slots_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

BIG = np.float32(bandit.BIG)
BITS = np.float32(146.4e6)
DEADLINE = 400.0
# the JAX references, compiled once per shape and S
JAX_LOCAL_TOPK = jax.jit(jref.local_topk_ref, static_argnums=2)
JAX_MERGE = jax.jit(jref.segmented_topk_ref, static_argnums=2)


# ---------------------------------------------------------------------------
# 1. local top-S and the cross-shard merge
# ---------------------------------------------------------------------------

def _topk_case(name, rng):
    """[R, C] scores and validity of one edge case."""
    r, c = 6, 37
    score = rng.choice(np.float32([-1.5, 0.25, 3.0, BIG]), size=(r, c))
    valid = rng.random((r, c)) < 0.6
    if name == "neg_inf":
        score[rng.random((r, c)) < 0.3] = -np.inf
    elif name == "all_invalid":
        valid[::2] = False
    elif name == "first_max_dead":      # all live scores -inf: ends early
        score[:] = -np.inf
        valid[:, 0] = False
    return score.astype(np.float32), valid


@pytest.mark.parametrize("case,s_round", [
    ("ties", 5), ("ties", 40), ("neg_inf", 7), ("all_invalid", 9),
    ("first_max_dead", 4)])
def test_local_topk_matches_jax(case, s_round):
    score, valid = _topk_case(case, np.random.default_rng(len(case)))
    vals, slots = ref.local_topk_ref(torch.from_numpy(score).view(2, 3, -1),
                                     torch.from_numpy(valid).view(2, 3, -1),
                                     s_round)
    assert vals.shape == slots.shape == (2, 3, s_round)
    vals, slots = vals.reshape(6, -1).numpy(), slots.reshape(6, -1).numpy()
    for i in range(score.shape[0]):
        jv, js = JAX_LOCAL_TOPK(jnp.asarray(score[i]),
                                jnp.asarray(valid[i]), s_round)
        np.testing.assert_array_equal(slots[i], np.asarray(js), f"row {i}")
        np.testing.assert_array_equal(vals[i], np.asarray(jv), f"row {i}")
    if case in ("neg_inf", "first_max_dead"):   # the Pallas kernel itself
        pv, ps = topk_slots_pallas(jnp.asarray(score[1]),
                                   jnp.asarray(valid[1]), s_round,
                                   interpret=True)
        np.testing.assert_array_equal(slots[1], np.asarray(ps))
        np.testing.assert_array_equal(vals[1], np.asarray(pv))
    if case == "first_max_dead":
        assert (slots == -1).all()
    # the routing: a CPU tensor takes the plain version
    ov, os_ = ops.local_topk(torch.from_numpy(score), torch.from_numpy(valid),
                             s_round)
    np.testing.assert_array_equal(os_.numpy(), slots)
    np.testing.assert_array_equal(ov.numpy(), vals)


@pytest.mark.parametrize("p,s_round", [(1, 3), (3, 4), (5, 6)])
def test_segmented_merge_matches_jax_and_flat(p, s_round):
    """Each shard ranks its own slots; the merge of the P local top-S equals
    the JAX merge and the flat top-S over all slots."""
    rng = np.random.default_rng(p)
    g, c = 4, 29
    score = rng.choice(rng.normal(size=3).astype(np.float32), size=(g, c))
    score[rng.random((g, c)) < 0.2] = BIG
    valid = rng.random((g, c)) < 0.8
    owner = rng.integers(0, p, size=(g, c))
    own = valid[:, None, :] & (owner[:, None, :] == np.arange(p)[None, :,
                                                                   None])
    local = np.where(own, score[:, None, :], -np.inf).astype(np.float32)
    lv, ls = ref.local_topk_ref(torch.from_numpy(local),
                                torch.from_numpy(own), s_round)
    got = ref.segmented_topk_ref(lv, ls, s_round).numpy()
    flat = bandit.top_slots(torch.from_numpy(score), torch.from_numpy(valid),
                            s_round).numpy()
    np.testing.assert_array_equal(got, flat)
    for i in range(g):
        want = JAX_MERGE(jnp.asarray(lv[i].numpy()),
                         jnp.asarray(ls[i].numpy()), s_round)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_segmented_merge_skips_exhausted_shards():
    vals = torch.tensor([[1.0, -np.inf], [-np.inf, -np.inf]])
    slots = torch.tensor([[2, -1], [-1, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        ref.segmented_topk_ref(vals, slots, 3).numpy(), [2, -1, -1])


# ---------------------------------------------------------------------------
# 2. the segmented round against JAX under vmap, and against the flat round
# ---------------------------------------------------------------------------

K, C, S, G, R = 64, 20, 4, 2, 3
ETAS = np.array([1.5, 1.9], np.float32)
FAULT = scenarios.get_scenario("flaky-clients").fault.probs


@functools.cache
def _jax_round(policy, p, failure):
    fn = bandit_jax.make_segmented_round_fn(
        policy, S, axis_name="shards", n_shards=p,
        fault=FAULT if failure else None,
        deadline=DEADLINE if failure else None)
    return jax.jit(jax.vmap(fn, in_axes=(0, None, None, None, 0, 0, 0, None,
                                         None, None), axis_name="shards"))


def _blocks(tree: dict, p: int):
    """One run's JAX state as P blocks (counters replicated)."""
    return bandit_jax.BanditState(**{
        n: jnp.asarray(np.broadcast_to(x, (p,)) if x.ndim == 0
                       else x.reshape(p, K // p, *x.shape[1:]))
        for n, x in tree.items()})


def _unblock(state) -> dict:
    """P JAX state blocks as one run's flat state tree."""
    tree = jax_tree(state)
    return {n: (x[0] if x.ndim == 1 else x.reshape(K, *x.shape[2:]))
            for n, x in tree.items()}


def _round_inputs(seed):
    """One draw of every round's inputs, from JAX keys (so the JAX function
    can draw them itself) and the same numbers as numpy arrays."""
    rng = np.random.default_rng(seed)
    env = scenarios.get_scenario("paper-baseline").build_env(K, rng)
    trees = [mid_run_tree(rng, K) for _ in range(G)]
    rounds = []
    for r in range(R):
        keys = [jax.random.split(jax.random.PRNGKey(100 * seed + 10 * r + g))
                for g in range(G)]
        rounds.append(dict(
            cand=sorted_candidates(rng, G, K, C, n_valid=C - 3),
            keys=keys,
            u2=np.stack([np.asarray(jax.random.uniform(kt, (2, C)))
                         for _, kt in keys]),
            rand=np.stack([np.asarray(jax.random.uniform(kp, (K,)))
                           for kp, _ in keys]),
            fault_u=np.stack([np.asarray(bandit_jax.fault_uniforms(kp, S))
                              for kp, _ in keys])))
    mult = rng.uniform(0.5, 1.5, (G, K)).astype(np.float32)
    theta = (env.mean_throughput_bps[None] * mult).astype(np.float32)
    gamma = np.broadcast_to(env.mean_capability, (G, K)).astype(np.float32)
    return trees, rounds, theta, gamma, env.n_samples.astype(np.float32)


@pytest.mark.parametrize("failure", [False, True], ids=["plain", "deadline"])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("policy", bandit.POLICY_NAMES)
def test_segmented_round_matches_jax(policy, p, failure):
    trees, rounds, theta, gamma, n_samples = _round_inputs(
        seed=bandit.POLICY_IDS[policy] + 8 * p + 40 * failure)
    fault = FAULT if failure else None
    deadline = DEADLINE if failure else None
    hyper = bandit.DEFAULT_HYPERS[policy]
    seg = bandit.make_segmented_round_fn(policy, S, n_shards=p, fault=fault,
                                         deadline=deadline)
    t = torch.from_numpy
    state = sharding.shard_state(bandit.state_from_tree(stack_trees(trees)),
                                 p)
    flat = bandit.state_from_tree(stack_trees(trees))
    jround = _jax_round(policy, p, failure)
    jstates = [_blocks(tr, p) for tr in trees]
    for r, d in enumerate(rounds):
        rand = t(d["rand"]) if policy == "random" else None
        fault_u = t(d["fault_u"]) if failure else None
        out = seg(state, t(d["cand"]), t(d["u2"]),
                  None if rand is None else sharding.shard_leading(rand, p, 1),
                  sharding.shard_leading(t(theta), p, 1),
                  sharding.shard_leading(t(gamma), p, 1),
                  sharding.shard_leading(t(n_samples), p, 0), t(ETAS),
                  float(BITS), hyper, fault_u=fault_u)
        state = out[0]
        # the port's flat round on the same inputs: bitwise
        fout = ref.bandit_round_sampled_ref(
            flat, t(d["cand"]), t(d["u2"]), rand, t(theta), t(gamma),
            t(n_samples), t(ETAS), float(BITS), hyper, policy=policy,
            s_round=S, decay=bandit.policy_decay(policy), fault=fault,
            deadline=deadline, fault_u=fault_u)
        flat = fout[0]
        for a, b in zip(out[1:], fout[1:]):
            assert torch.equal(a, b), f"{policy} round {r}: flat differs"
        for g in range(G):
            kp, kt = d["keys"][g]
            jout = jround(jstates[g], jnp.asarray(d["cand"][g]), kp, kt,
                          jnp.asarray(theta[g].reshape(p, -1)),
                          jnp.asarray(gamma[g].reshape(p, -1)),
                          jnp.asarray(n_samples.reshape(p, -1)),
                          jnp.float32(ETAS[g]), BITS, jnp.float32(hyper))
            jstates[g] = jout[0]
            where = f"{policy} P={p} round {r} grid point {g}"
            np.testing.assert_array_equal(out[1][g].numpy(),
                                          np.asarray(jout[1][0]), where)
            np.testing.assert_allclose(float(out[2][g]), float(jout[2][0]),
                                       rtol=1e-6, err_msg=where)
            if failure:
                np.testing.assert_array_equal(out[3][g].numpy(),
                                              np.asarray(jout[3][0]), where)
    got = convert.state_tree(sharding.unshard_state(state, p))
    assert_states_match(got, [_unblock(s) for s in jstates], 1e-6, policy)
    for name, x in convert.state_tree(flat).items():
        np.testing.assert_array_equal(got[name], x, name)


# ---------------------------------------------------------------------------
# 3. the sweep: segmented against flat, routing and refusals
# ---------------------------------------------------------------------------

SWEEP_KW = dict(policies=tuple(bandit.POLICY_NAMES), etas=(1.5, 1.9),
                seeds=2, n_rounds=6, n_clients=96, frac_request=0.25,
                fast_sampling=True, device="cpu")


@pytest.mark.parametrize("scen,deadline", [
    ("correlated-congestion", None), ("flaky-clients", DEADLINE),
    ("client-churn", None)])
def test_sharded_sweep_equals_flat_bitwise(scen, deadline):
    flat = engine.sweep(scen, deadline=deadline, **SWEEP_KW)
    for p in (2, 4):
        got = engine.sweep(scen, deadline=deadline, shard="clients",
                           devices=p, **SWEEP_KW)
        np.testing.assert_array_equal(got.round_times, flat.round_times)
        if deadline is not None:
            np.testing.assert_array_equal(got.flags, flat.flags)


def test_sharded_sweep_routing(monkeypatch):
    """P dividing K on the streamed fused path runs the segmented rounds;
    an uneven K, the legacy path or the unfused path run flat."""
    calls = []
    real = bandit.make_segmented_round_fn

    def spy(*a, **kw):
        calls.append(kw["n_shards"])
        return real(*a, **kw)
    monkeypatch.setattr(bandit, "make_segmented_round_fn", spy)
    kw = dict(SWEEP_KW, policies=("naive_ucb",), n_rounds=2)
    engine.sweep(**kw, shard="clients", devices=4)
    assert calls == [4]
    for extra in (dict(n_clients=98), dict(fast_sampling=False),
                  dict(fused=False)):
        flat = engine.sweep(**dict(kw, **extra))
        got = engine.sweep(**dict(kw, **extra), shard="clients", devices=4)
        np.testing.assert_array_equal(got.round_times, flat.round_times)
    assert calls == [4]


def test_sharding_helpers():
    assert sharding.even_shards(96, 4) == 24
    assert sharding.even_shards(98, 4) is None
    assert sharding.even_shards(96, None) is None
    x = torch.arange(12).view(1, 12)
    assert sharding.shard_leading(x, 3, 1)[0, 1].tolist() == [4, 5, 6, 7]
    state = bandit.state_from_tree(stack_trees(
        [mid_run_tree(np.random.default_rng(i), 12) for i in range(2)]))
    blocks = sharding.shard_state(state, 3)
    assert blocks.n_sel.shape == (6, 4) and blocks.hist_ud.shape == (6, 4, 5)
    assert blocks.total.tolist() == state.total.repeat_interleave(3).tolist()
    back = sharding.unshard_state(blocks, 3)
    for name in bandit.STATE_FIELDS:
        assert torch.equal(getattr(back, name), getattr(state, name))
    # per-shard bytes at K = 10^6 over 8 shards: the JAX package's formula
    from repro.distributed.sharding import bandit_state_bytes
    for k, p in ((10**6, 8), (1000, 3), (64, 1)):
        assert sharding.bandit_state_bytes(k, p) == bandit_state_bytes(k, p)


def test_sweep_refusals():
    """An unknown shard mode raises; with no process group,
    ``devices="all"`` is one shard, so ``shard="clients"`` gives the flat
    sweep's result, as the JAX package does on one device."""
    kw = dict(n_rounds=2, seeds=1, device="cpu")
    with pytest.raises(ValueError, match="shard mode"):
        engine.sweep(**kw, shard="rows")
    one = engine.sweep(**kw, devices="all", shard="clients")
    flat = engine.sweep(**kw)
    np.testing.assert_array_equal(one.round_times, flat.round_times)


# ---------------------------------------------------------------------------
# 4. the candidate draw's tie rule
# ---------------------------------------------------------------------------

def test_candidate_topk_ties_go_to_lowest_index():
    """Uniforms with many ties across the rank-n boundary: ``torch.topk``
    takes another set than ``lax.top_k`` in some rows; ``topk_lowest``
    takes ``lax.top_k``'s in every row."""
    rng = np.random.default_rng(0)
    k, n, rows = 1000, 100, 40
    u = (rng.integers(0, 300, (rows, k)) / 300.0).astype(np.float32)
    want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(u), n)[1]), axis=1)
    got = engine.topk_lowest(torch.from_numpy(u), n).numpy()
    np.testing.assert_array_equal(got, want)
    plain = np.sort(torch.from_numpy(u).topk(n, dim=1).indices.numpy(), 1)
    assert (plain != want).any(axis=1).sum() > 0
    # value order of bandit.top_k is lax.top_k's own, negative values and
    # infinities included
    x = np.concatenate([u, rng.choice(np.float32(
        [-np.inf, -2.5, -1.0, -0.25, 0.0, 0.5, 3.0, np.inf]),
        size=(rows, k))]).astype(np.float32)
    np.testing.assert_array_equal(
        bandit.top_k(torch.from_numpy(x), n).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(x), n)[1]))
