"""The port's ``sim.engine.sweep`` against the JAX package's
``engine_jax.sweep`` from the seeds alone, on the CPU: no replay, the port
drawing the JAX package's numbers from the same Threefry keys
(``sim/engine.KeyStreams``).

  1. all 8 policies on the legacy path (permutation-prefix candidates,
     [K] Eq. (8) uniforms from the theta and gamma keys) and the streamed
     path (top-k-of-uniforms candidates, one [2, C] block from the theta
     key), fused and unfused, and the streamed default at K = 1024;
     flaky-clients with a deadline (flags equal); metro-congestion's
     normals; churn's four subkeys; ``hierarchy="cells"`` (per-cell
     ``fold_in`` draws); ``chunk_rounds``;
  2. on 2 and 4 gloo ranks (``tests/_torch_dist.py``), ``shard="grid"``
     and ``shard="clients"`` bitwise the one-process sweep, each rank's
     count of drawn values showing that it drew only for the seeds of its
     own rows (grid) or only its K/R slice of the candidate and the random
     policy's uniforms (clients).

Tolerances: flags exact; round times within rtol 1e-6 (the Eq. (8)
transform's float32 erfinv is within 2 ulp of XLA's, and the UCB bonuses
carry last-ulp differences of XLA's and PyTorch's transcendentals, as in
tests/test_torch_sweep.py), 1e-5 where congestion or churn apply (the
congestion factor exp(sigma * normal) of a normal within 3 ulp of jax's;
a churned client's mean throughput through the float32 link budget,
within 5.2e-6 of XLA's).  The round times follow every selection, so equal
times within these bounds mean equal selections; the flags are exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_ranks, sweeps  # noqa: E402

from repro.core import bandit_jax  # noqa: E402
from repro.sim import engine_jax  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

ALL = tuple(bandit_jax.POLICY_NAMES)
BASE = dict(etas=(1.5, 1.9), seeds=(0, 3), n_rounds=8, n_clients=40,
            frac_request=0.25)
STREAMED = dict(BASE, fast_sampling=True)
CASES = {
    "legacy-fused": dict(BASE, policies=ALL),
    "legacy-unfused": dict(BASE, policies=ALL, fused=False),
    "streamed-fused": dict(STREAMED, policies=ALL),
    "streamed-unfused": dict(STREAMED, policies=ALL, fused=False),
    "streamed-default-1024": dict(BASE, n_clients=1024, frac_request=0.02,
                                  n_rounds=4,
                                  policies=("naive_ucb", "random")),
    "flaky-deadline": dict(BASE, scenario="flaky-clients", deadline=400.0,
                           policies=("elementwise_ucb", "random")),
    "metro-congestion": dict(BASE, scenario="metro-congestion",
                             n_clients=200, frac_request=0.05,
                             policies=("naive_ucb", "extended_fedcs")),
    "churn": dict(BASE, scenario="client-churn", n_clients=16,
                  frac_request=1.0, n_rounds=16,
                  policies=("discounted_ucb", "random")),
    "cells": dict(BASE, scenario="metro-congestion", n_clients=300,
                  frac_request=0.1, hierarchy="cells",
                  policies=("elementwise_ucb", "random")),
    "chunked": dict(BASE, chunk_rounds=4, policies=("random",)),
    "chunked-streamed-churn": dict(STREAMED, scenario="client-churn",
                                   n_clients=16, frac_request=1.0,
                                   n_rounds=12, chunk_rounds=3,
                                   policies=("naive_ucb",)),
}


def _rtol(kw: dict) -> float:
    scen = kw.get("scenario", "paper-baseline")
    return 1e-5 if ("congestion" in scen or "churn" in scen) else 1e-6


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_from_seeds_matches_jax(name):
    kw = CASES[name]
    want = engine_jax.sweep(**kw)
    got = engine.sweep(device="cpu", **kw)
    assert got.round_times.shape == want.round_times.shape
    np.testing.assert_allclose(got.round_times, want.round_times,
                               rtol=_rtol(kw), atol=0, err_msg=name)
    if want.flags is None:
        assert got.flags is None
    else:
        np.testing.assert_array_equal(got.flags, want.flags, name)
    assert got.drawn["cand"] > 0 or kw.get("hierarchy") == "cells"


@pytest.mark.parametrize("fast", [False, True], ids=["legacy", "streamed"])
def test_key_draws_are_contiguous(fast):
    """Every draw a round hands on is contiguous (the card's kernels take
    only contiguous tensors), with one row a seed and with rows spread
    over etas, from the first chunk of rounds and a later one."""
    scen = scenarios.Scenario("all-streams", congestion_cells=5,
                              congestion_sigma=0.3, churn_prob=0.2,
                              fault=scenarios.FaultModel(crash_prob=0.1))
    for rows in (None, torch.tensor([0, 1, 0, 1])):
        streams = engine.KeyStreams((0, 3), 6, "cpu", rows=rows, chunk=3)
        for rnd in (0, 4):
            d = engine.draw_round_inputs(
                streams, rnd=rnd, k=40, n_req=10, s_round=5, fast=fast,
                fluctuate=True, policy="random", scen=scen,
                fault=scen.fault.probs)
            for f in dataclasses.fields(d):
                x = getattr(d, f.name)
                assert x is None or x.is_contiguous(), (f.name, rows, rnd)


# ---------------------------------------------------------------------------
# 2. ranks: each draws its own rows or its own clients
# ---------------------------------------------------------------------------

RANKED = dict(etas=(1.0, 1.5), seeds=3, n_rounds=5, n_clients=64,
              frac_request=0.25)
RANK_CASES = {
    "grid-legacy": dict(RANKED, policies=("fedcs", "random"), devices=4),
    "grid-streamed-flaky": dict(RANKED, scenario="flaky-clients",
                                deadline=2500.0, fast_sampling=True,
                                policies=("naive_ucb",), devices=4),
    "clients": dict(RANKED, fast_sampling=True, shard="clients", devices=4,
                    policies=("elementwise_ucb", "random")),
    "clients-churn-chunked": dict(RANKED, scenario="client-churn",
                                  fast_sampling=True, shard="clients",
                                  devices=8, chunk_rounds=1,
                                  policies=("naive_ucb",)),
}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    runs = {1: [sweeps(0, 1, RANK_CASES, True)]}
    for world in (2, 4):
        runs[world] = run_ranks(sweeps, world,
                                tmp_path_factory.mktemp(f"draws{world}"),
                                RANK_CASES, True)
    return runs


def _want_drawn(kw: dict, world: int, rank: int) -> dict:
    """The candidate and random-policy uniforms a rank should draw."""
    k, r, n_seeds = kw["n_clients"], kw["n_rounds"], kw["seeds"]
    n_pol = len(kw["policies"])
    n_rand = sum(p == "random" for p in kw["policies"])
    if kw.get("shard", "grid") == "grid":
        g = len(kw["etas"]) * n_seeds
        rows = sharding.grid_rows(g, sharding.ShardGroup(world, world, rank))
        seeds = len(set((rows % n_seeds).tolist()))
        return {"cand": seeds * k * r * n_pol, "pol": seeds * k * r * n_rand}
    width = k // world
    return {"cand": n_seeds * width * r * n_pol,
            "pol": n_seeds * width * r * n_rand}


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(RANK_CASES))
def test_ranks_draw_their_own_rows(rank_runs, name, world):
    flat_rts, flat_flags, flat_drawn = rank_runs[1][0][name]
    assert len(rank_runs[world]) == world
    for rank, res in enumerate(rank_runs[world]):
        rts, flags, drawn = res[name]
        where = f"{name} on rank {rank} of {world}"
        assert np.array_equal(rts, flat_rts), where
        assert (flags is None) == (flat_flags is None), where
        if flags is not None:
            assert np.array_equal(flags, flat_flags), where
        want = _want_drawn(RANK_CASES[name], world, rank)
        assert {s: drawn[s] for s in want} == want, where
        # the small streams and the Eq. (8) block stay whole on each rank
        # of the clients layout, and follow the rows of the grid one
        if RANK_CASES[name].get("shard") == "clients":
            assert drawn["time"] == flat_drawn["time"], where
