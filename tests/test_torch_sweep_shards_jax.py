"""The port's grid- and client-sharded sweeps and ``chunk_rounds`` against
the JAX package's ``engine_jax.sweep`` with the same ``shard``,
``devices=4`` and ``chunk_rounds``, on the CPU, from the seeds alone.

The port draws the JAX package's random numbers from the same per-seed
Threefry keys (``sim/engine.KeyStreams``), so the two sweeps agree as they
stand.  The JAX side runs once, in a subprocess whose environment alone
carries ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (a 4-device
mesh: ``shard_map`` over the grid or over 4 client blocks with ``psum`` and
``all_gather``).  The port's ``sweep`` runs with the same arguments on 1
process and on each rank of 2 and 4 gloo ranks: its shard layout, its
collectives, its padded grid, ``chunk_rounds``, and the draws each rank
makes of its own rows or clients.

Cases: a greedy, a score and the random policy, flaky-clients with a
deadline, client churn and cell congestion, over ``shard="grid"`` and
``"clients"``, with and without ``chunk_rounds``.

Tolerances: flags exact; round times within rtol 1e-6 (the Eq. (8) draws
and UCB bonuses carry last-ulp differences of XLA's and PyTorch's
transcendentals, as in tests/test_torch_sweep.py), and within 1e-5 in the
churn cases: a fresh client's mean throughput comes from the float32 link
budget (``10 ** (snr_db / 10)`` of ``log10`` terms), which amplifies
those last-ulp differences; on 10^5 random distances the two packages'
link budgets differ by up to 5.2e-6 relative (measured on the CPU), and a
churned client's round times by up to 5.1e-6.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_ranks, sweeps  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

BASE = dict(etas=(1.0, 1.5), seeds=3, n_rounds=6, n_clients=64,
            frac_request=0.25, fast_sampling=True, devices=4)
# churn at 16 clients, all polled, over 24 rounds: a replaced client is
# often selected afterwards, so a wrong pick shows in the round times
CHURN = dict(BASE, scenario="client-churn", n_clients=16, frac_request=1.0,
             n_rounds=24)
CASES = {
    "clients-fedcs-chunked": dict(BASE, scenario="paper-baseline",
                                  policies=("fedcs",), shard="clients",
                                  chunk_rounds=3),
    "clients-congestion": dict(BASE, scenario="correlated-congestion",
                               policies=("naive_ucb",), shard="clients"),
    "clients-churn-random": dict(CHURN, policies=("random",),
                                 shard="clients", chunk_rounds=2),
    "clients-flaky": dict(BASE, scenario="flaky-clients", deadline=2500.0,
                          policies=("elementwise_ucb",), shard="clients"),
    "grid-flaky-chunked": dict(BASE, scenario="flaky-clients",
                               deadline=2500.0, policies=("naive_ucb",),
                               shard="grid", chunk_rounds=2),
    "grid-churn": dict(CHURN, policies=("discounted_ucb",), shard="grid"),
}

JAX_SCRIPT = r"""
import json, sys
import jax, numpy as np
from repro.sim import engine_jax

assert jax.device_count() == 4
cases = json.loads(sys.argv[1])
out = {}
for name, kw in cases.items():
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    res = engine_jax.sweep(**kw)
    out[f"{name}:rts"] = np.asarray(res.round_times)
    if res.flags is not None:
        out[f"{name}:flags"] = np.asarray(res.flags)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's round times and flags of every case on 4 devices."""
    tmp = tmp_path_factory.mktemp("sweep_shards_jax")
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(CASES),
         str(tmp / "out.npz")],
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's sweeps from the seeds on 1 process (no group) and on
    every rank of 2 and 4 gloo ranks."""
    runs = {1: [sweeps(0, 1, CASES)]}
    for world in (2, 4):
        runs[world] = run_ranks(sweeps, world,
                                tmp_path_factory.mktemp(f"sweeps{world}"),
                                CASES)
    return runs


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_sweep_matches_jax_sharded_sweep(jax_runs, port_runs, name,
                                                 world):
    out = jax_runs
    want_rts, want_flags = out[f"{name}:rts"], out.get(f"{name}:flags")
    assert len(port_runs[world]) == world
    for rank, res in enumerate(port_runs[world]):
        rts, flags = res[name]
        where = f"{name} on rank {rank} of {world}"
        assert rts.shape == want_rts.shape, where
        np.testing.assert_allclose(rts, want_rts, err_msg=where,
                                   rtol=1e-5 if "churn" in name else 1e-6)
        if want_flags is None:
            assert flags is None, where
        else:
            np.testing.assert_array_equal(flags, want_flags, where)
