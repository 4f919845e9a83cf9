"""The port's naive-UCB score and index-based selection API against the JAX
package, on the CPU.

  1. ``kernels/ref.ucb_scores_ref`` against the JAX ``ucb_scores_ref`` and
     the Pallas ``ucb_scores`` in interpret mode (as the JAX package's own
     tests run it), with never-selected arms, at a K past one Pallas block;
  2. every ``select_*`` index function and every ``SELECT_FNS`` mask
     function against its JAX counterpart, on mid-run states with the BIG
     cold-start ties.

Tolerances: selections exact; scores within 1e-6 of the magnitude of their
two terms, |mean / alpha| + bonus: XLA's float32 log and PyTorch's may
differ in the last ulp, and the sum of the two terms cancels near zero.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (mid_run_tree, sorted_candidates,  # noqa: E402
                           stack_trees)

from repro.core import bandit_jax  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ucb_score import ucb_scores as jucb_pallas  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

G, K, C, S = 3, 150, 30, 5


def _ucb_inputs(k, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, (G, k)).astype(np.int32)
    n[rng.random((G, k)) < 0.25] = 0
    sums = (n * rng.uniform(1.0, 900.0, (G, k))).astype(np.float32)
    total = np.array([0, 1, n[2].sum()], np.int32)      # log max(total, 2)
    return sums, n, total


@pytest.mark.parametrize("k,alpha", [(5000, 1000.0), (37, 3.5)])
def test_ucb_scores_ref_matches_jax(k, alpha):
    sums, n, total = _ucb_inputs(k)
    got = ref.ucb_scores_ref(torch.from_numpy(sums), torch.from_numpy(n),
                             torch.from_numpy(total), alpha).numpy()
    assert got.dtype == np.float32 and got.shape == (G, k)
    nf = np.maximum(n, 1).astype(np.float64)
    scale = (np.abs(sums / nf / alpha) + np.sqrt(
        np.log(np.maximum(total, 2))[:, None] / (2 * nf)))
    scale = np.where(n == 0, np.float64(bandit.BIG), scale)
    for g in range(G):
        want = np.asarray(jref.ucb_scores_ref(
            jnp.asarray(sums[g]), jnp.asarray(n[g]), jnp.asarray(total[g]),
            alpha))
        pallas = np.asarray(jucb_pallas(
            jnp.asarray(sums[g]), jnp.asarray(n[g]), jnp.asarray(total[g]),
            alpha=alpha, interpret=True))
        for other in (want, pallas):
            err = np.abs(got[g].astype(np.float64) - other)
            assert (err <= 1e-6 * scale[g]).all(), (g, err.max())
    assert (got[n == 0] == np.float32(bandit.BIG)).all()
    routed = ops.ucb_scores(torch.from_numpy(sums), torch.from_numpy(n),
                            torch.from_numpy(total), alpha)
    np.testing.assert_array_equal(routed.numpy(), got)


@pytest.mark.parametrize("alpha", sorted(set(bandit.DEFAULT_HYPERS.values()))
                         + [700.0, 3.5, 0.1, 1 / 3, 1e-40, 3.4028235e38,
                            1.0000000596046448, 16777217.0, -2.5])
def test_kernel_alpha_rounds_as_float32(alpha):
    """The kernel wrapper passes alpha as ``ctypes.c_float``; it must round
    a Python float as ``np.float32`` (the plain version's float32 alpha)
    does, ties and subnormals included."""
    import ctypes
    assert ctypes.c_float(alpha).value == float(np.float32(alpha))


def test_kernel_wrapper_refuses_bad_inputs():
    """CPU tensors, wrong dtypes and shapes are refused before any launch
    (a CUDA tensor with n_sel or total on another device is refused too:
    chip_smoke.py phase 9 checks that on the card)."""
    from repro_torch.kernels import ucb_score as tucb
    sums, n, total = (torch.from_numpy(x) for x in _ucb_inputs(16))
    before = dict(tucb.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tucb.ucb_scores_cuda(sums, n, total)
    for args, what in [((sums.double(), n, total), "float32"),
                       ((sums[0], n, total), "float32"),
                       ((sums, n.long(), total), "n_sel must be an int32"),
                       ((sums, n[:, :8], total), "n_sel must be an int32"),
                       ((sums, n, total.float()), "total must be an int32"),
                       ((sums, n, total[:2]), "total must be an int32")]:
        with pytest.raises(ValueError, match=what):
            tucb.ucb_scores_cuda(*args)
    assert tucb.launch_counts == before


# ---------------------------------------------------------------------------
# 2. the selection API
# ---------------------------------------------------------------------------

def _states(seed=1):
    rng = np.random.default_rng(seed)
    trees = [mid_run_tree(rng, K) for _ in range(G)]
    cands = sorted_candidates(rng, G, K, C)
    ud = rng.uniform(1.0, 300.0, (G, K)).astype(np.float32)
    ul = rng.uniform(1.0, 300.0, (G, K)).astype(np.float32)
    keys = [jax.random.PRNGKey(7 + g) for g in range(G)]
    rand = np.stack([np.asarray(jax.random.uniform(kk, (K,)))
                     for kk in keys])
    return trees, cands, ud, ul, keys, rand


def _jstate(tree):
    return bandit_jax.BanditState(**{n: jnp.asarray(x)
                                     for n, x in tree.items()})


@pytest.mark.parametrize("fn", ["elementwise", "naive", "naive_kernel",
                                "naive_formula", "fedcs", "extended_fedcs",
                                "random", "oracle"])
def test_select_index_api_matches_jax(fn):
    trees, cands, ud, ul, keys, rand = _states()
    state = bandit.state_from_tree(stack_trees(trees))
    c = torch.from_numpy(cands)
    port = {
        "elementwise": lambda: bandit.select_elementwise(state, c, S, 40.0),
        "naive": lambda: bandit.select_naive(state, c, S, 700.0),
        "naive_kernel": lambda: bandit.select_naive(state, c, S, 700.0,
                                                    use_kernel=True),
        "naive_formula": lambda: bandit.select_naive(state, c, S, 700.0,
                                                     use_kernel=False),
        "fedcs": lambda: bandit.select_fedcs(state, c, S),
        "extended_fedcs": lambda: bandit.select_extended_fedcs(state, c, S),
        "random": lambda: bandit.select_random(state, c, S,
                                               torch.from_numpy(rand)),
        "oracle": lambda: bandit.select_oracle(state, c, S,
                                               torch.from_numpy(ud),
                                               torch.from_numpy(ul)),
    }[fn]()
    assert port.shape == (G, S) and port.dtype == torch.int32
    for g in range(G):
        st, cg = _jstate(trees[g]), jnp.asarray(cands[g])
        want = {
            "elementwise": lambda: bandit_jax.select_elementwise(st, cg, S,
                                                                 40.0),
            "naive": lambda: bandit_jax.select_naive(st, cg, S, 700.0),
            "naive_kernel": lambda: bandit_jax.select_naive(
                st, cg, S, 700.0, use_kernel=True),
            "naive_formula": lambda: bandit_jax.select_naive(
                st, cg, S, 700.0, use_kernel=False),
            "fedcs": lambda: bandit_jax.select_fedcs(st, cg, S),
            "extended_fedcs": lambda: bandit_jax.select_extended_fedcs(
                st, cg, S),
            "random": lambda: bandit_jax.select_random(st, cg, S, keys[g]),
            "oracle": lambda: bandit_jax.select_oracle(
                st, cg, S, jnp.asarray(ud[g]), jnp.asarray(ul[g])),
        }[fn]()
        np.testing.assert_array_equal(port[g].numpy(), np.asarray(want),
                                      f"{fn} row {g}")


@pytest.mark.parametrize("policy", bandit.POLICY_NAMES)
def test_mask_select_fns_match_jax(policy):
    trees, cands, ud, ul, keys, rand = _states(seed=2)
    state = bandit.state_from_tree(stack_trees(trees))
    mask = bandit.candidate_mask(K, torch.from_numpy(cands))
    hyper = bandit.DEFAULT_HYPERS[policy]
    fn = bandit.make_select_fn(policy, S)
    got = fn(state, mask, torch.from_numpy(rand), torch.from_numpy(ud),
             torch.from_numpy(ul), hyper)
    # a tensor hyper takes the policy formula, a Python number (naive UCB)
    # the score kernel's route: the same selections
    got_t = fn(state, mask, torch.from_numpy(rand), torch.from_numpy(ud),
               torch.from_numpy(ul), torch.tensor(hyper))
    np.testing.assert_array_equal(got.numpy(), got_t.numpy())
    jfn = bandit_jax.make_select_fn(policy, S)
    for g in range(G):
        jmask = bandit_jax.candidate_mask(K, jnp.asarray(cands[g]))
        want = jfn(_jstate(trees[g]), jmask, keys[g], jnp.asarray(ud[g]),
                   jnp.asarray(ul[g]), jnp.float32(hyper))
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(want),
                                      f"{policy} row {g}")


def test_select_random_from_a_generator():
    trees, cands, *_ = _states(seed=3)
    state = bandit.state_from_tree(stack_trees(trees))
    gen = torch.Generator().manual_seed(5)
    sel = bandit.select_random(state, torch.from_numpy(cands), S, gen)
    for g in range(G):
        assert set(sel[g].tolist()) <= set(cands[g].tolist())
        assert len(set(sel[g].tolist())) == S
    with pytest.raises(ValueError, match="unknown policy"):
        bandit.make_select_fn("nope", S)


def test_select_pads_when_candidates_run_out():
    """Fewer candidates than S: -1 padding, as in the JAX package."""
    trees, *_ = _states(seed=4)
    state = bandit.state_from_tree(stack_trees(trees))
    cands = torch.tensor([[3, 9], [0, 149], [5, 6]], dtype=torch.int32)
    for fn in (lambda: bandit.select_naive(state, cands, 4),
               lambda: bandit.select_elementwise(state, cands, 4)):
        sel = fn()
        assert (sel[:, 2:] == -1).all()
        assert all(set(sel[g, :2].tolist()) == set(cands[g].tolist())
                   for g in range(G))
