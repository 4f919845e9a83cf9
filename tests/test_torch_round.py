"""Per-round parity of the port's fused round (repro_torch.kernels.ops, the
plain version on CPU tensors) against the JAX package's
``ops.bandit_round`` / ``ops.bandit_round_sampled`` with
``use_kernel=False``: all 8 policies, the legacy and the candidate-sliced
path, with the failure layer off and on, over 30 chained rounds fed the
same numpy draws.

Selections, flags and every integer leaf must match exactly.  Float leaves
and round times are held to rtol 1e-6: XLA's and PyTorch's log, sqrt, pow
and log1p may differ in the last ulp, and the sliced path's Eq. (8) times
inherit that.  One case also runs the Pallas kernel in interpret mode.
"""

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_states_match, jax_tree,  # noqa: E402
                           mid_run_tree, sorted_candidates, stack_trees)

from repro.core import bandit_jax  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.sim.scenarios import SCENARIOS as JAX_SCENARIOS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.kernels import bandit_round as cuda_round  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sim.scenarios import get_scenario  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

K, C, S, G, R = 48, 12, 4, 2, 30
ETAS = np.array([1.0, 1.9], np.float32)
MODEL_BITS = np.float32(146.4e6)
DEADLINE = 350.0
RTOL = 1e-6     # last-ulp differences of XLA vs PyTorch transcendentals


def _inputs(policy, sliced, seed):
    """Numpy draws for R rounds of a G=2 grid."""
    rng = np.random.default_rng(seed)
    cand = np.stack([sorted_candidates(rng, G, K, C,
                                       n_valid=C if r % 7 else S - 1)
                     for r in range(R)])           # some exhausted rounds
    d = dict(cand=cand, fault_u=rng.random((R, G, 3, S), np.float32))
    d["rand"] = (rng.random((R, G, K), np.float32) if policy == "random"
                 else None)
    if sliced:
        d["u2"] = rng.random((R, G, 2, C), np.float32)
        d["theta"] = rng.uniform(2e5, 8e6, (G, K)).astype(np.float32)
        d["gamma"] = rng.uniform(10, 100, (G, K)).astype(np.float32)
        d["n_samples"] = rng.integers(100, 1001, K).astype(np.float32)
    else:
        # a few exact duplicates so Algorithm 1 meets finite ties
        d["t_ud"] = np.round(rng.uniform(1, 60, (R, G, K))).astype(np.float32)
        d["t_ul"] = np.round(rng.uniform(5, 200, (R, G, K))).astype(
            np.float32)
    return d


@functools.cache
def _jax_round_fn(policy, sliced, failure):
    """The JAX package's fused round for one grid point, jitted once per
    case (XLA may contract a multiply-add there, within RTOL)."""
    kw = dict(policy=policy, s_round=S, decay=bandit_jax.policy_decay(policy),
              use_kernel=False)
    if failure:
        kw.update(fault=JAX_SCENARIOS["flaky-clients"].fault.probs,
                  deadline=DEADLINE)
    fn = jops.bandit_round_sampled if sliced else jops.bandit_round
    return jax.jit(functools.partial(fn, **kw))


def _jax_round(policy, sliced, failure, st, d, r, g):
    hyper = jnp.float32(bandit_jax.DEFAULT_HYPERS[policy])
    fn = _jax_round_fn(policy, sliced, failure)
    kw = {"fault_u": jnp.asarray(d["fault_u"][r, g])} if failure else {}
    rand = None if d["rand"] is None else jnp.asarray(d["rand"][r, g])
    cand = jnp.asarray(d["cand"][r, g])
    if sliced:
        return fn(st, cand, jnp.asarray(d["u2"][r, g]), rand,
                  jnp.asarray(d["theta"][g]), jnp.asarray(d["gamma"][g]),
                  jnp.asarray(d["n_samples"]), jnp.float32(ETAS[g]),
                  MODEL_BITS, hyper, **kw)
    return fn(st, cand, jnp.asarray(d["t_ud"][r, g]),
              jnp.asarray(d["t_ul"][r, g]), rand, hyper, **kw)


def _port_round(policy, sliced, failure, st, d, r):
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
    kw = dict(policy=policy, s_round=S, decay=bandit.policy_decay(policy))
    if failure:
        kw.update(fault=get_scenario("flaky-clients").fault.probs,
                  deadline=DEADLINE, fault_u=t(d["fault_u"][r]))
    rand = None if d["rand"] is None else t(d["rand"][r])
    hyper = bandit.DEFAULT_HYPERS[policy]
    if sliced:
        return ops.bandit_round_sampled(
            st, t(d["cand"][r]), t(d["u2"][r]), rand, t(d["theta"]),
            t(d["gamma"]), t(d["n_samples"]), t(ETAS), float(MODEL_BITS),
            hyper, **kw)
    return ops.bandit_round(st, t(d["cand"][r]), t(d["t_ud"][r]),
                            t(d["t_ul"][r]), rand, hyper, **kw)


@pytest.mark.parametrize("failure", [False, True], ids=["no-deadline",
                                                        "flaky-deadline"])
@pytest.mark.parametrize("sliced", [False, True], ids=["legacy", "sliced"])
@pytest.mark.parametrize("policy", bandit.POLICY_NAMES)
def test_round_matches_jax(policy, sliced, failure):
    d = _inputs(policy, sliced,
                seed=4 * bandit.POLICY_IDS[policy] + 2 * sliced + failure)
    rng = np.random.default_rng(11)
    trees = [mid_run_tree(rng, K) for _ in range(G)]
    jstates = [bandit_jax.state_from_tree(t) for t in trees]
    pstate = bandit.state_from_tree(stack_trees(trees))
    for r in range(R):
        pout = _port_round(policy, sliced, failure, pstate, d, r)
        pstate = pout[0]
        for g in range(G):
            jout = _jax_round(policy, sliced, failure, jstates[g], d, r, g)
            jstates[g] = jout[0]
            where = f"{policy} round {r} grid point {g}"
            np.testing.assert_array_equal(pout[1][g].numpy(),
                                          np.asarray(jout[1]), where)
            np.testing.assert_allclose(float(pout[2][g]), float(jout[2]),
                                       rtol=RTOL, err_msg=where)
            if failure:
                np.testing.assert_array_equal(pout[3][g].numpy(),
                                              np.asarray(jout[3]), where)
    assert_states_match(convert.state_tree(pstate),
                        [jax_tree(s) for s in jstates], RTOL, policy)


def test_round_matches_pallas_interpret():
    """One case through the JAX package's Pallas kernel itself (interpret
    mode, jitted as its own tests run it)."""
    policy = "elementwise_ucb"
    d = _inputs(policy, False, seed=3)
    tree = mid_run_tree(np.random.default_rng(5), K)
    pstate = bandit.state_from_tree(tree)
    jst = bandit_jax.state_from_tree(tree)
    fault = JAX_SCENARIOS["flaky-clients"].fault.probs
    kern = jax.jit(lambda st, cand, tu, tl, fu: jops.bandit_round(
        st, cand, tu, tl, None, jnp.float32(bandit_jax.DEFAULT_BETA),
        policy=policy, s_round=S, use_kernel=True, interpret=True,
        fault=fault, deadline=DEADLINE, fault_u=fu))
    for r in range(3):
        jst, jsel, jrt, jflags = kern(
            jst, jnp.asarray(d["cand"][r, 0]), jnp.asarray(d["t_ud"][r, 0]),
            jnp.asarray(d["t_ul"][r, 0]), jnp.asarray(d["fault_u"][r, 0]))
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x[r, :1]))
        pstate, psel, prt, pflags = ops.bandit_round(
            pstate, t(d["cand"]), t(d["t_ud"]), t(d["t_ul"]), None,
            bandit.DEFAULT_BETA, policy=policy, s_round=S, fault=fault,
            deadline=DEADLINE, fault_u=t(d["fault_u"]))
        np.testing.assert_array_equal(psel[0].numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(pflags[0].numpy(), np.asarray(jflags))
        np.testing.assert_allclose(float(prt[0]), float(jrt), rtol=RTOL)
    assert_states_match(convert.state_tree(pstate), [jax_tree(jst)], RTOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches or raises: it never falls back to the
    plain version (kernels/ops.py routes by device instead)."""
    st = bandit.BanditState.create(1, 8)
    cand = torch.arange(4, dtype=torch.int32)[None]
    t = torch.ones(1, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_round.bandit_round_cuda(st, cand, t, t, None, 50.0,
                                     policy="fedcs", s_round=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_round.bandit_round_sampled_cuda(
            st, cand, torch.rand(1, 2, 4), None, t, t, t[0],
            torch.ones(1), 1e6, 50.0, policy="fedcs", s_round=2)


def test_round_args_layout_matches_cuda_struct():
    """The ctypes mirror lists the fields of ``struct RoundArgs`` in the
    CUDA source in the same order (the library also checks the size when
    it loads)."""
    src = (Path(bandit.__file__).parents[1] / "kernels" / "csrc"
           / "bandit_round.cu").read_text()
    body = re.search(r"struct RoundArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[\d+\]", "", decl).strip()
        if decl:
            names += [re.sub(r"^.*[\s*]", "", v.strip())
                      for v in decl.split(",")]
    assert names == [f[0] for f in cuda_round._RoundArgs._fields_]
