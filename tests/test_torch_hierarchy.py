"""The port's hierarchical cell selection against the JAX package, on the
CPU.

  1. ``cell_scores``, ``select_cells`` and ``update_cell_stats`` against
     JAX on cold and tied cell aggregates;
  2. ``hier_cand_idx`` on the JAX package's own per-cell uniforms
     (``jax.random.uniform(fold_in(key, c), (m,))``) against JAX's
     ``hier_cand_idx(key, ...)``, and on tied uniforms against
     ``lax.top_k``'s choice;
  3. hierarchical rounds through the replay seam (``RoundRunner`` with
     ``cells=``) against the same JAX functions composed in a loop;
  4. the invariants of tests/test_hierarchy.py: candidates stay inside the
     selected cells, short cells pad with K, the cell aggregates conserve
     the valid picks, one cell gives the flat sweep bitwise, and the
     refusals.

Tolerances: cell ids, candidates, selections, flags and counts exact;
cell scores, T_inc sums and round times within rtol 1e-6.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import assert_states_match, jax_tree  # noqa: E402

from repro.core import bandit_jax  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
from repro_torch.sim.scenarios import Scenario  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

BITS = np.float32(146.4e6)


# ---------------------------------------------------------------------------
# 1. the cell bandit
# ---------------------------------------------------------------------------

def _aggregates(g=3, n_cells=12, seed=0):
    rng = np.random.default_rng(seed)
    cell_n = rng.integers(0, 6, (g, n_cells)).astype(np.float32)
    cell_n[0] = 0.0                                   # all cold
    cell_n[1, ::2] = 3.0                              # tied counts
    cell_tinc = (cell_n * rng.uniform(50, 400, (g, n_cells))).astype(
        np.float32)
    cell_tinc[1, ::2] = 600.0                         # tied means
    return cell_n, cell_tinc


@pytest.mark.parametrize("s_cells,alpha", [(4, 1000.0), (12, 5.0)])
def test_cell_scores_and_selection_match_jax(s_cells, alpha):
    cell_n, cell_tinc = _aggregates()
    score = bandit.cell_scores(torch.from_numpy(cell_n),
                               torch.from_numpy(cell_tinc), alpha).numpy()
    sel = bandit.select_cells(torch.from_numpy(cell_n),
                              torch.from_numpy(cell_tinc), s_cells,
                              alpha).numpy()
    assert sel.dtype == np.int32 and sel.shape == (3, s_cells)
    for g in range(3):
        jn, jt = jnp.asarray(cell_n[g]), jnp.asarray(cell_tinc[g])
        np.testing.assert_allclose(
            score[g], np.asarray(bandit_jax.cell_scores(jn, jt, alpha)),
            rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            sel[g], np.asarray(bandit_jax.select_cells(jn, jt, s_cells,
                                                       alpha)))
    assert (score[0] == np.float32(bandit.BIG)).all()
    np.testing.assert_array_equal(sel[0], np.arange(s_cells))   # ties: low


def test_update_cell_stats_matches_jax_and_conserves():
    rng = np.random.default_rng(1)
    g, k, n_cells = 3, 40, 6
    cell_id = np.arange(k) % n_cells
    sel = np.stack([rng.choice(k, 5, replace=False) for _ in range(g)])
    sel[0, 3:] = -1
    sel[2, :] = [1, 7, 13, 19, 25]                    # one cell, five picks
    pre = rng.uniform(0, 900, (g, k)).astype(np.float32)
    post = pre.copy()
    for i in range(g):
        ok = sel[i][sel[i] >= 0]
        post[i, ok] += rng.uniform(10, 300, len(ok)).astype(np.float32)
    cn0, ct0 = _aggregates(g, n_cells, seed=2)
    cn, ct = bandit.update_cell_stats(
        torch.from_numpy(cn0), torch.from_numpy(ct0),
        torch.from_numpy(sel.astype(np.int32)), torch.from_numpy(pre),
        torch.from_numpy(post), torch.from_numpy(cell_id), n_cells)
    for i in range(g):
        jn, jt = bandit_jax.update_cell_stats(
            jnp.asarray(cn0[i]), jnp.asarray(ct0[i]),
            jnp.asarray(sel[i].astype(np.int32)), jnp.asarray(pre[i]),
            jnp.asarray(post[i]), jnp.asarray(cell_id), n_cells)
        np.testing.assert_array_equal(cn[i].numpy(), np.asarray(jn))
        np.testing.assert_allclose(ct[i].numpy(), np.asarray(jt), rtol=1e-6)
    # conservation: the counts grow by the valid picks, the sums by the
    # picks' increments
    np.testing.assert_array_equal((cn.numpy() - cn0).sum(1),
                                  (sel >= 0).sum(1))
    np.testing.assert_allclose((ct.numpy() - ct0).sum(1),
                               (post - pre).sum(1), rtol=1e-5)
    assert cn[2, 1] - cn0[2, 1] == 5.0


# ---------------------------------------------------------------------------
# 2. the per-cell candidate draw
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=2)
def _cell_uniforms(key, cells_sel, m):
    return jax.vmap(lambda c: jax.random.uniform(
        jax.random.fold_in(key, c), (m,), jnp.float32))(cells_sel)


def _jax_cell_uniforms(keys, cells_sel, m):
    """[G, s_cells, m]: the uniforms ``hier_cand_idx`` draws per cell."""
    return np.stack([np.asarray(_cell_uniforms(kk, jnp.asarray(row), m))
                     for kk, row in zip(keys, cells_sel)])


# the JAX functions of the hierarchical round, compiled once per shape
J_SELECT_CELLS = jax.jit(bandit_jax.select_cells, static_argnums=2)
J_HIER_CAND = jax.jit(bandit_jax.hier_cand_idx, static_argnums=(2, 3, 4))
J_UPDATE_CELLS = jax.jit(bandit_jax.update_cell_stats, static_argnums=6)


@pytest.mark.parametrize("k,n_cells,n_req_cell,cells", [
    (103, 10, 4, [[7, 2, 9], [0, 1, 2]]),
    (12, 10, 2, [[5], [0]]),                  # short cells pad with K
    (300, 7, 30, [[6, 3, 0, 1], [2, 4, 5, 6]])])
def test_hier_cand_idx_matches_jax(k, n_cells, n_req_cell, cells):
    cells_sel = np.asarray(cells, np.int32)
    m = -(-k // n_cells)
    keys = [jax.random.PRNGKey(3 + i) for i in range(len(cells))]
    u = _jax_cell_uniforms(keys, cells_sel, m)
    got = bandit.hier_cand_idx(torch.from_numpy(u),
                               torch.from_numpy(cells_sel), k, n_cells,
                               n_req_cell).numpy()
    assert got.shape == (len(cells), cells_sel.shape[1] * n_req_cell)
    for g, key in enumerate(keys):
        want = J_HIER_CAND(key, jnp.asarray(cells_sel[g]), k, n_cells,
                           n_req_cell)
        np.testing.assert_array_equal(got[g], np.asarray(want))
        real = got[g][got[g] < k]
        assert set(np.unique(real % n_cells)) <= set(cells_sel[g].tolist())
        assert len(np.unique(real)) == len(real)
        assert (np.sort(got[g]) == got[g]).all() and (got[g] <= k).all()
    if k == 12:
        np.testing.assert_array_equal(got[0], [5, k])
        np.testing.assert_array_equal(got[1], [0, 10])


def test_hier_cand_idx_ties_go_to_lowest_index():
    """Tied uniforms at rank n_req_cell: the lower member index wins, the
    choice ``lax.top_k`` makes."""
    rng = np.random.default_rng(4)
    k, n_cells, n_req = 200, 4, 9
    m = k // n_cells
    cells_sel = np.array([[3, 0], [1, 2]], np.int32)
    u = (rng.integers(0, 5, (2, 2, m)) / 5.0).astype(np.float32)
    got = bandit.hier_cand_idx(torch.from_numpy(u),
                               torch.from_numpy(cells_sel), k, n_cells,
                               n_req).numpy()
    for g in range(2):
        want = []
        for i, c in enumerate(cells_sel[g]):
            _, pos = jax.lax.top_k(jnp.asarray(u[g, i]), n_req)
            want += (np.asarray(pos) * n_cells + c).tolist()
        np.testing.assert_array_equal(got[g], np.sort(want))


# ---------------------------------------------------------------------------
# 3. hierarchical rounds through the seam against a JAX loop
# ---------------------------------------------------------------------------

K, N_CELLS, S_CELLS, N_REQ_CELL, S, R = 60, 6, 3, 4, 3, 6
CELL_SCEN = Scenario("cells-test", congestion_cells=N_CELLS,
                     congestion_sigma=0.5)
FAULT_SCEN = Scenario("cells-flaky", congestion_cells=N_CELLS,
                      congestion_sigma=0.5,
                      fault=scenarios.get_scenario("flaky-clients").fault)
ETAS = np.array([1.5, 1.9], np.float32)
DEADLINE = 400.0


@functools.cache
def _jax_round(policy, failure):
    scen = FAULT_SCEN if failure else CELL_SCEN
    return jax.jit(bandit_jax.make_sampled_round_fn(
        policy, S, fault=scen.fault if failure else None,
        deadline=DEADLINE if failure else None))


@pytest.mark.parametrize("policy,failure", [
    ("elementwise_ucb", False), ("naive_ucb", False), ("random", True),
    ("discounted_ucb", False), ("fedcs", True)])
def test_hier_rounds_match_jax_loop(policy, failure):
    scen = FAULT_SCEN if failure else CELL_SCEN
    deadline = DEADLINE if failure else None
    rng = np.random.default_rng(bandit.POLICY_IDS[policy])
    env_np = scen.build_env(K, rng)
    env = engine.EnvArrays.from_scenario(scen, env_np)
    jenv = convert.env_tree(env)
    m = -(-K // N_CELLS)
    c = S_CELLS * N_REQ_CELL
    hyper = bandit.DEFAULT_HYPERS[policy]
    jround = _jax_round(policy, failure)
    normals = rng.standard_normal((R, 2, N_CELLS)).astype(np.float32)
    # the JAX loop, one grid point at a time; it records the draws the port
    # gets: per selected cell the uniforms fold_in(key, cell) gives
    rounds = [dict(u_time=[], rand=[], fault_u=[], cell_u=[])
              for _ in range(R)]
    want_rt, want_flags, want_cells, want_state = [], [], [], []
    for g in range(2):
        st = bandit_jax.BanditState.create(K)
        cn = jnp.zeros(N_CELLS)
        ct = jnp.zeros(N_CELLS)
        rts, fls = [], []
        for r in range(R):
            kc, kp, kt = jax.random.split(jax.random.PRNGKey(50 * g + r), 3)
            cells_sel = J_SELECT_CELLS(cn, ct, S_CELLS)
            cand = J_HIER_CAND(kc, cells_sel, K, N_CELLS, N_REQ_CELL)
            mult = np.exp(scen.congestion_sigma * normals[r, g])[
                jenv["cell_id"]]
            out = jround(st, cand, kp, kt, jnp.asarray(jenv["mean_theta"]
                                                       * mult),
                         jnp.asarray(jenv["mean_gamma"]),
                         jnp.asarray(jenv["n_samples"]), jnp.float32(ETAS[g]),
                         BITS, jnp.float32(hyper))
            cn, ct = J_UPDATE_CELLS(
                cn, ct, out[1], st.sum_tinc, out[0].sum_tinc,
                jnp.asarray(jenv["cell_id"]), N_CELLS)
            st = out[0]
            rts.append(float(out[2]))
            if failure:
                fls.append(np.asarray(out[3]))
            d = rounds[r]
            d["cell_u"].append(_jax_cell_uniforms(
                [kc], np.asarray(cells_sel)[None], m)[0])
            d["u_time"].append(np.asarray(jax.random.uniform(kt, (2, c))))
            d["rand"].append(np.asarray(jax.random.uniform(kp, (K,))))
            d["fault_u"].append(np.asarray(bandit_jax.fault_uniforms(kp, S)))
        want_rt.append(rts)
        want_flags.append(fls)
        want_cells.append((np.asarray(cn), np.asarray(ct)))
        want_state.append(jax_tree(st))

    runner = engine.RoundRunner(
        env, torch.from_numpy(ETAS), policy=policy, scen=scen, s_round=S,
        hyper=hyper, model_bits=float(BITS), fast=True, deadline=deadline,
        cells=(S_CELLS, N_REQ_CELL))
    for r, d in enumerate(rounds):
        t = {key: torch.from_numpy(np.stack(v)) for key, v in d.items()}
        draws = engine.RoundDraws(
            cand=None, u_time=t["u_time"],
            rand=t["rand"] if policy == "random" else None,
            fault_u=t["fault_u"] if failure else None,
            cong=torch.from_numpy(normals[r]), cell_u=t["cell_u"])
        _, rt, flags = runner.step(r + 1, draws)
        for g in range(2):
            where = f"{policy} round {r} grid point {g}"
            np.testing.assert_allclose(float(rt[g]), want_rt[g][r], rtol=1e-6,
                                       err_msg=where)
            if failure:
                np.testing.assert_array_equal(flags[g].numpy(),
                                              want_flags[g][r], where)
    for g in range(2):
        np.testing.assert_array_equal(runner.cell_n[g].numpy(),
                                      want_cells[g][0])
        np.testing.assert_allclose(runner.cell_tinc[g].numpy(),
                                   want_cells[g][1], rtol=1e-6)
    assert_states_match(convert.state_tree(runner.state), want_state, 1e-6,
                        policy)


# ---------------------------------------------------------------------------
# 4. the sweep
# ---------------------------------------------------------------------------

HIER_KW = dict(etas=(1.5,), seeds=2, n_rounds=8, s_round=3,
               frac_request=0.2, n_clients=300, device="cpu")


def test_one_cell_reduces_to_flat_bitwise():
    kw = dict(HIER_KW, policies=("elementwise_ucb", "naive_ucb"))
    a = engine.sweep("paper-baseline", **kw, hierarchy="cells")
    b = engine.sweep("paper-baseline", **kw)
    np.testing.assert_array_equal(a.round_times, b.round_times)


def test_hier_sweep_candidates_stay_in_selected_cells(monkeypatch):
    """Every round of a metro-congestion sweep polls only members of the
    cells it selected, C = s_cells * n_req_cell of them."""
    seen = []
    real = bandit.hier_cand_idx

    def spy(u, cells_sel, k, n_cells, n_req_cell):
        out = real(u, cells_sel, k, n_cells, n_req_cell)
        seen.append((out, cells_sel, n_cells, n_req_cell))
        return out
    monkeypatch.setattr(bandit, "hier_cand_idx", spy)
    res = engine.sweep("metro-congestion", policies=("elementwise_ucb",
                                                     "naive_ucb",
                                                     "discounted_ucb"),
                       hierarchy="cells", **HIER_KW)
    assert res.round_times.shape == (3, 1, 2, 8)
    assert np.isfinite(res.round_times).all() and (res.round_times > 0).all()
    assert len(seen) == 3 * 8
    n_req = math.ceil(300 * 0.2)
    for cand, cells_sel, n_cells, n_req_cell in seen:
        assert n_cells == 100 and cells_sel.shape == (2, 10)
        assert n_req_cell == min(-(-n_req // 10), 3)
        for g in range(2):
            real_c = cand[g][cand[g] < 300]
            assert set((real_c % n_cells).tolist()) <= set(
                cells_sel[g].tolist())


def test_hier_sweep_s_cells_and_faults():
    scen = Scenario("metro-flaky", congestion_cells=50, congestion_sigma=0.5,
                    fault=scenarios.get_scenario("flaky-clients").fault)
    res = engine.sweep(scen, policies=("elementwise_ucb", "random"),
                       hierarchy="cells", s_cells=5, deadline=100.0,
                       **HIER_KW)
    assert res.flags is not None and np.isfinite(res.round_times).all()
    fc = res.fault_counts()
    parts = sum(fc[k] for k in ("ok", "crashed", "churned",
                                "deadline_missed", "corrupt"))
    np.testing.assert_array_equal(parts, fc["dispatched"])


def test_hierarchy_refusals():
    kw = dict(HIER_KW, policies=("random",))
    with pytest.raises(ValueError, match="hierarchy"):
        engine.sweep("metro-congestion", **kw, hierarchy="nope")
    with pytest.raises(ValueError, match="shard"):
        engine.sweep("metro-congestion", **kw, hierarchy="cells",
                     shard="clients")
    with pytest.raises(ValueError, match="fast_sampling"):
        engine.sweep("metro-congestion", **kw, hierarchy="cells",
                     fast_sampling=False)
