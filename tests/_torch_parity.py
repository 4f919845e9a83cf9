"""Shared helpers of the port's parity tests (tests/test_torch_*.py): numpy-
made inputs and the moves between the JAX package's states and the port's,
the small CNN configs of the FL tests and the JAX-key-to-order derivation.

Both packages get the same numpy arrays; the JAX side runs one grid point
at a time, the port runs the [G] grid at once.
"""

import dataclasses

import numpy as np


def mid_run_tree(rng: np.random.Generator, k: int, w: int = 5) -> dict:
    """A plausible mid-run bandit state of one run as a dict of numpy
    arrays in the JAX package's layout: some arms never selected (the BIG
    sentinel), some with full and some with partial ring buffers, decayed
    statistics with cold entries."""
    n_sel = rng.integers(0, 8, k).astype(np.int32)
    n_sel[rng.random(k) < 0.2] = 0
    hist_n = np.minimum(n_sel, w).astype(np.int32)
    hist = lambda: np.where(np.arange(w)[None] < hist_n[:, None],
                            rng.uniform(1, 300, (k, w)), 0).astype(np.float32)
    sums = lambda: (n_sel * rng.uniform(1, 300, k)).astype(np.float32)
    last = lambda: np.where(n_sel > 0, rng.uniform(1, 300, k),
                            0).astype(np.float32)
    disc_n = (n_sel * rng.uniform(0.0, 1.0, k)).astype(np.float32)
    disc_n[rng.random(k) < 0.1] = 0.005          # below the cold threshold
    return dict(
        n_sel=n_sel, sum_ud=sums(), sum_ul=sums(), sum_tinc=sums(),
        total=np.int32(n_sel.sum()), last_ud=last(), last_ul=last(),
        hist_ud=hist(), hist_ul=hist(), hist_n=hist_n, disc_n=disc_n,
        disc_ud=(disc_n * rng.uniform(1, 300, k)).astype(np.float32),
        disc_ul=(disc_n * rng.uniform(1, 300, k)).astype(np.float32),
        disc_total=np.float32(disc_n.sum()),
        n_fail=rng.integers(0, 2, k).astype(np.int32))


def stack_trees(trees: list[dict]) -> dict:
    """[G]-batch a list of single-run trees."""
    return {name: np.stack([t[name] for t in trees]) for name in trees[0]}


def jax_tree(state) -> dict:
    """A JAX-package BanditState as a dict of numpy arrays."""
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def sorted_candidates(rng: np.random.Generator, g: int, k: int, c: int,
                      n_valid: int | None = None) -> np.ndarray:
    """[G, C] int32 sorted candidate indices; with ``n_valid`` < C the last
    C - n_valid slots are padding (index K)."""
    n_valid = c if n_valid is None else n_valid
    out = np.full((g, c), k, np.int32)
    for i in range(g):
        out[i, :n_valid] = np.sort(rng.choice(k, n_valid, replace=False))
    return out


def assert_states_match(port_tree: dict, jax_trees: list[dict], rtol: float,
                        msg: str = "") -> None:
    """Integer leaves exactly, float leaves within ``rtol``; ``port_tree``
    is [G]-batched, ``jax_trees`` one dict per grid point."""
    for name, got in port_tree.items():
        want = np.stack([t[name] for t in jax_trees])
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {msg}")
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                       err_msg=f"{name} {msg}")


# ---------------------------------------------------------------------------
# FL slice: small CNN configs and the clients' epoch orders
# ---------------------------------------------------------------------------

# the small CNN of tests/test_fl_engine.py (one pool, one hidden fc layer)
SMALL_CNN = dict(image_size=8, channels=(8, 8), pool_after=(0,),
                 fc_units=(16,))
# two pools and two hidden fc layers: fc0 sees a 2x2x8 map, so a flatten
# in the wrong (c, h, w) order shows in the logits
TWO_POOL_CNN = dict(image_size=8, channels=(4, 6, 8), pool_after=(0, 2),
                    fc_units=(12, 10))


def cnn_configs(kw: dict, batchnorm: bool):
    """(JAX package's, port's) ``CnnConfig`` of the same fields."""
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn as tcnn
    return (jcnn.CnnConfig(batchnorm=batchnorm, **kw),
            tcnn.CnnConfig(batchnorm=batchnorm, **kw))


def jax_orders(perm_key, clients, counts, cap: int, epochs: int,
               native: bool) -> np.ndarray:
    """[len(clients), E, cap] epoch orders, drawn as the JAX package's
    ``fl.engine.make_client_update`` draws them for the clients of
    ``_train_round``: key ``fold_in(perm_key, client)``, split into E epoch
    keys, then ``argsort(uniform + 2*(pos >= count))`` or, with ``native``
    (every shard full), ``jax.random.permutation``."""
    import jax
    import jax.numpy as jnp

    pos = jnp.arange(cap)

    def one(client, count):
        keys = jax.random.split(jax.random.fold_in(perm_key, client), epochs)
        if native:
            return jax.vmap(lambda kk: jax.random.permutation(kk, cap))(keys)
        return jax.vmap(lambda kk: jnp.argsort(
            jax.random.uniform(kk, (cap,)) + 2.0 * (pos >= count)))(keys)
    return np.asarray(jax.vmap(one)(jnp.asarray(clients),
                                    jnp.asarray(counts)))


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over flat float64 copies."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# Async slice: the JAX package's per-tick draws as the port's TickDraws
# ---------------------------------------------------------------------------

def jax_tick_draws(scen_name: str, cfg, seed: int, n: int, k: int, *,
                   perm: dict | None = None) -> list:
    """The random inputs JAX's async tick draws from ``tick_keys(seed, n,
    0, n)``, as the port's ``TickDraws`` (CPU tensors): the candidate mask
    and the Eq. (8) uniforms (``poll_inputs``), the Poisson arrival count,
    the random policy's uniforms and the fault uniforms (both from the
    ``"pol"`` key) and the congestion normals.  The churn draws become the
    port's four uniforms: the victim's ``randint`` j as (j + 0.5) / K.
    ``perm`` = dict(counts=, cap=, epochs=, native=) adds every client's
    epoch orders from the FL twin's ``"perm"`` keys (:func:`jax_orders`).
    """
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import bandit_jax
    from repro.sim import async_engine as jae
    from repro.sim import engine_jax
    from repro.sim.scenarios import get_scenario
    from repro_torch.sim.async_engine import TickDraws

    scen = get_scenario(scen_name)
    keys = jae.tick_keys(seed, n, 0, n, perm=perm is not None)
    fault = bandit_jax.resolve_fault(scen.fault, cfg.deadline)

    def one(kk, t):
        d = {"cand_mask": engine_jax._cand_masks_from_keys(
                 kk["cand"][None], k, cfg.n_req)[0],
             "u_time": jnp.stack([jax.random.uniform(kk["theta"], (k,)),
                                  jax.random.uniform(kk["gamma"], (k,))]),
             "rand": jax.random.uniform(kk["pol"], (k,))}
        if cfg.arrival == "full":
            d["n_arr"] = jnp.int32(cfg.s_dispatch)
        else:
            lam = cfg.arrival_rate * engine_jax.scenario_diurnal_mult(
                scen, (t + 1)[None])[0]
            d["n_arr"] = jax.random.poisson(kk["arr"], lam).astype(jnp.int32)
        if fault is not None:
            d["fault_u"] = bandit_jax.fault_uniforms(kk["pol"],
                                                     cfg.s_dispatch)
        if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0:
            d["cong"] = jax.random.normal(kk["cong"],
                                          (scen.congestion_cells,))
        if scen.churn_prob > 0.0:
            kc1, kc2, kc3, kc4 = jax.random.split(kk["churn"], 4)
            j = jax.random.randint(kc2, (), 0, k)
            d["churn"] = jnp.stack([
                jax.random.uniform(kc1), (j.astype(jnp.float32) + 0.5) / k,
                jax.random.uniform(kc3), jax.random.uniform(kc4)])
        return d

    out = jax.vmap(jax.jit(one))(keys, jnp.arange(n, dtype=jnp.int32))
    out = {name: np.asarray(v) for name, v in out.items()}
    if perm is not None:
        out["orders"] = np.stack([jax_orders(
            keys["perm"][t], np.arange(k), perm["counts"], perm["cap"],
            perm["epochs"], perm["native"]) for t in range(n)])
    return [TickDraws(**{name: torch.tensor(np.array(v[t]))
                         for name, v in out.items()}) for t in range(n)]


def async_trees_match(port_state, jax_state, rtol: float,
                      msg: str = "") -> None:
    """An async state of the port against the JAX package's, field by
    field through their snapshot trees: integers exactly, floats within
    ``rtol``."""
    import jax

    from repro.sim import async_engine as jae
    from repro_torch.sim import async_engine as ae

    want = jax.tree.map(np.asarray, jae.snapshot_tree(jax_state))
    got = ae.snapshot_tree(port_state)
    for name, w in want.items():
        pairs = (w.items() if name == "bandit" else [(name, w)])
        sub = got["bandit"] if name == "bandit" else got
        for leaf, wv in pairs:
            gv = sub[leaf].cpu().numpy()
            if np.issubdtype(wv.dtype, np.integer):
                np.testing.assert_array_equal(gv, wv,
                                              err_msg=f"{leaf} {msg}")
            else:
                np.testing.assert_allclose(gv, wv, rtol=rtol, atol=0,
                                           err_msg=f"{leaf} {msg}")
