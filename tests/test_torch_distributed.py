"""The port's sweeps over ``torch.distributed`` ranks and with
``chunk_rounds``, on the CPU.

  1. ``chunk_rounds`` = 1, 2, 5 of 10 rounds gives the unchunked result
     bitwise: ``sim.engine.sweep`` on the legacy fused, the streamed fused
     and the unfused path, and ``fl.engine.accuracy_sweep`` on a small CNN;
  2. ``sweep(shard="grid", devices=4)`` and ``sweep(shard="clients",
     devices=4 and 8)`` on 1 process and on 2 and 4 gloo ranks
     (``tests/_torch_dist.py``): a greedy policy, a score policy,
     ``random``, flaky-clients with a deadline, churn and cell congestion —
     every rank's round times and flags bitwise the one-process flat
     sweep's, which tests/test_torch_sweep.py and test_torch_segmented.py
     hold against the JAX package;
  3. ``accuracy_sweep(shard="clients", devices=4)`` on 2 ranks, on the
     legacy path and on the streamed path's segmented rounds, bitwise the
     flat sweep; ``shard="grid"`` on 2 ranks with selections and round
     times bitwise and accuracy within 1e-3 (the vmapped convolutions
     round differently for a different number of client models a call;
     the JAX package's own test holds its client-sharded accuracy at
     atol 1e-3);
  4. a ``devices`` that does not split over the ranks raises.

Tolerance: none but (3)'s accuracy.  Each spawned run holds several cases,
so the file spawns four runs of ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import (accuracy_sweeps, refusals, run_ranks,  # noqa: E402
                         sweeps)

from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.fl import engine as fl  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.sim import engine  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

SWEEP = dict(n_rounds=6, seeds=3, etas=(1.0, 1.5), n_clients=64,
             frac_request=0.25)
POLICIES = ("fedcs", "naive_ucb", "random")     # greedy, score, random
FLAKY = dict(SWEEP, scenario="flaky-clients", deadline=2500.0,
             policies=("elementwise_ucb", "naive_ucb"))
STREAMED = dict(SWEEP, fast_sampling=True)
CASES = {
    "grid": dict(SWEEP, policies=POLICIES, devices=4),
    "grid-flaky": dict(FLAKY, devices=4),
    "grid-cells": dict(SWEEP, scenario="correlated-congestion",
                       policies=("elementwise_ucb",), hierarchy="cells",
                       devices=4),
    "clients-4": dict(STREAMED, policies=POLICIES, shard="clients",
                      devices=4),
    "clients-8": dict(STREAMED, policies=POLICIES, shard="clients",
                      devices=8),
    "clients-8-flaky": dict(FLAKY, fast_sampling=True, shard="clients",
                            devices=8),
    "clients-4-churn": dict(STREAMED, scenario="client-churn",
                            policies=("elementwise_ucb", "naive_ucb"),
                            shard="clients", devices=4),
    "clients-4-congestion": dict(STREAMED, scenario="correlated-congestion",
                                 policies=("discounted_ucb", "random"),
                                 shard="clients", devices=4),
}
SHARD_KEYS = ("devices", "shard")

SMALL_CNN = dict(image_size=8, channels=(8, 8), pool_after=(0,),
                 fc_units=(16,), batchnorm=False)
TASK = dict(n_clients=16, n_train=600, n_test=400, eval_batch=200,
            max_samples=40, batch_size=10)
FL_RUN = dict(policies=("fedcs", "elementwise_ucb"), seeds=2, n_rounds=3,
              s_round=3, frac_request=0.5, epochs=1, batch_size=10)
FL_CASES = {
    "clients-4": dict(FL_RUN, shard="clients", devices=4),
    "clients-4-streamed": dict(FL_RUN, shard="clients", devices=4,
                               fast_sampling=True),
    "grid-2": dict(FL_RUN, devices=2),
}


def _flat(kw: dict) -> dict:
    return {k: v for k, v in kw.items() if k not in SHARD_KEYS}


@pytest.fixture(scope="module")
def flat_sweeps():
    return {name: engine.sweep(device="cpu", **_flat(kw))
            for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every case's result on 1 process (no group) and on each rank of 2
    and 4 gloo ranks."""
    out = {1: [sweeps(0, 1, CASES)]}
    for world in (2, 4):
        out[world] = run_ranks(sweeps, world,
                               tmp_path_factory.mktemp(f"sweeps{world}"),
                               CASES)
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_over_ranks_is_the_flat_sweep(ranked, flat_sweeps, name,
                                            world):
    flat = flat_sweeps[name]
    assert len(ranked[world]) == world
    for rank, res in enumerate(ranked[world]):
        rts, flags = res[name]
        assert np.array_equal(rts, flat.round_times), (name, world, rank)
        if flat.flags is None:
            assert flags is None
        else:
            assert np.array_equal(flags, flat.flags), (name, world, rank)


def test_devices_must_split_over_the_ranks(tmp_path):
    cases = {"three": dict(n_rounds=2, seeds=1, devices=3),
             "clients-three": dict(n_rounds=2, seeds=1, devices=3,
                                   shard="clients"),
             "all": dict(n_rounds=2, seeds=1, devices="all")}
    for res in run_ranks(refusals, 2, tmp_path, cases):
        assert "3 shards do not split evenly over 2 ranks" in res["three"]
        assert "over 2 ranks" in res["clients-three"]
        assert res["all"] is None


@pytest.fixture(scope="module")
def fl_runs(tmp_path_factory):
    cfg = cnn.CnnConfig(**SMALL_CNN)
    task = fl.make_cnn_task("paper-baseline", cfg=cfg, device="cpu", **TASK)
    flat = {name: fl.accuracy_sweep(task=task, cfg=cfg, device="cpu",
                                    **_flat(kw))
            for name, kw in FL_CASES.items()}
    ranks = run_ranks(accuracy_sweeps, 2, tmp_path_factory.mktemp("fl"),
                      TASK, SMALL_CNN, FL_CASES)
    return flat, ranks


@pytest.mark.parametrize("name", sorted(FL_CASES))
def test_accuracy_sweep_over_ranks(fl_runs, name):
    flat, ranks = fl_runs
    ref = flat[name]
    for rank, res in enumerate(ranks):
        sel, rts, acc = res[name]
        assert np.array_equal(sel, ref.selected), (name, rank)
        assert np.array_equal(rts, ref.round_times), (name, rank)
        if name.startswith("grid"):
            np.testing.assert_allclose(acc, ref.accuracy, atol=1e-3)
        else:
            assert np.array_equal(acc, ref.accuracy), (name, rank)


@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("path", ["legacy", "streamed", "unfused"])
def test_sweep_chunk_rounds_is_unchunked(path, c):
    kw = dict(SWEEP, n_rounds=10, policies=("elementwise_ucb", "random"),
              device="cpu", fast_sampling=path == "streamed",
              fused=path != "unfused")
    ref = engine.sweep(**kw)
    got = engine.sweep(**kw, chunk_rounds=c)
    assert np.array_equal(got.round_times, ref.round_times)


@pytest.fixture(scope="module")
def fl_task():
    cfg = cnn.CnnConfig(**SMALL_CNN)
    return cfg, fl.make_cnn_task("paper-baseline", cfg=cfg, device="cpu",
                                 **TASK)


@pytest.mark.parametrize("c", [1, 2, 5])
def test_accuracy_sweep_chunk_rounds_is_unchunked(fl_task, c):
    cfg, task = fl_task
    kw = dict(FL_RUN, policies=("elementwise_ucb",), seeds=1, n_rounds=10,
              cohort="selected", task=task, cfg=cfg, device="cpu")
    ref = fl.accuracy_sweep(**kw)
    got = fl.accuracy_sweep(**kw, chunk_rounds=c)
    for key in ("selected", "round_times", "accuracy"):
        assert np.array_equal(getattr(got, key), getattr(ref, key)), key


def test_shard_groups_on_one_process():
    assert sharding.resolve_group(None) is None
    assert sharding.resolve_group(1) is None
    assert sharding.resolve_group("all") is None        # world size 1
    sg = sharding.resolve_group(4)
    assert (sg.n_shards, sg.world, sg.rank, sg.per_rank, sg.first,
            sg.group) == (4, 1, 0, 4, 0, None)
    with pytest.raises(ValueError, match="devices"):
        sharding.resolve_group("some")
    assert sharding.place(4) == sg
    x = torch.arange(6).view(3, 2)
    assert sharding.pad_leading(x, 4).tolist() == [[0, 1], [2, 3], [4, 5],
                                                   [4, 5]]
    assert sharding.pad_leading(x, 3) is x
    two = sharding.ShardGroup(4, world=2, rank=1)
    assert sharding.grid_rows(5, two).tolist() == [3, 4, 4]
    assert sharding.grid_rows(6, two).tolist() == [3, 4, 5]
    assert sharding.grid_rows(6, sharding.ShardGroup(4)).tolist() == [
        0, 1, 2, 3, 4, 5]
    assert sharding.sum_shards(torch.ones(2, 3), 1).tolist() == [3.0, 3.0]
    y = torch.ones(2, 3, 1)
    assert sharding.gather_shards(y) is y
