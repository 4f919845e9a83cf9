"""Shared helpers of the port's parity tests (tests/test_torch_*.py): numpy-
made inputs and the moves between the JAX package's states and the port's.

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
