"""The port's grid- and client-sharded sweeps and ``chunk_rounds`` against
the JAX package's ``engine_jax.sweep`` with the same ``shard``,
``devices=4`` and ``chunk_rounds``, on the CPU.

The two packages draw their random numbers from different generators
(JAX's per-round Threefry keys, the port's torch generators), so their
sweeps cannot agree as they stand.  The JAX side therefore runs once, in a
subprocess whose environment alone carries
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (a 4-device mesh:
``shard_map`` over the grid or over 4 client blocks with ``psum`` and
``all_gather``), and also writes out every round's random inputs as its
sweep draws them from its keys: candidates, Eq. (8) uniforms, the random
policy's and the fault uniforms, congestion normals, churn draws.  The
port's ``sweep`` then runs with those inputs replayed in place of its own
draws (``_torch_dist.replayed_sweeps``), on 1 process and on each rank of 2
and 4 gloo ranks, everything else its own: the shard layout, the
collectives, the padded grid and ``chunk_rounds``.

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
churned client's round times by up to 5.1e-6.  The churn draw's
client index is replayed as the uniform (j + 0.5) / K, which the port's
``floor(u * K)`` maps back to JAX's ``randint`` pick j.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import replayed_sweeps, run_ranks  # noqa: E402
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
import json, math, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import bandit_jax
from repro.sim import engine_jax
from repro.sim.scenarios import get_scenario

assert jax.device_count() == 4
cases = json.loads(sys.argv[1])
out = {}


def churn_uniforms(key, k):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    j = jax.random.randint(k2, (), 0, k)
    return jnp.stack([jax.random.uniform(k1),
                      (j.astype(jnp.float32) + 0.5) / k,
                      jax.random.uniform(k3), jax.random.uniform(k4)])


for name, kw in cases.items():
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    res = engine_jax.sweep(**kw)
    out[f"{name}:rts"] = np.asarray(res.round_times)
    if res.flags is not None:
        out[f"{name}:flags"] = np.asarray(res.flags)
    scen = get_scenario(kw["scenario"])
    k, r, s = kw["n_clients"], kw["n_rounds"], kw.get("s_round", 5)
    n_req = math.ceil(k * kw["frac_request"])
    streams = {"cand": lambda kk: engine_jax._cand_topk_one(kk, k, n_req),
               "u_time": lambda kk: jax.random.uniform(kk, (2, n_req),
                                                       jnp.float32),
               "rand": lambda kk: jax.random.uniform(kk, (k,)),
               "fault_u": lambda kk: bandit_jax.fault_uniforms(kk, s)}
    root = {"cand": 0, "u_time": 1, "rand": 3, "fault_u": 3}
    if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0:
        streams["cong"] = lambda kk: jax.random.normal(
            kk, (scen.congestion_cells,))
        root["cong"] = 4
    if scen.churn_prob > 0.0:
        streams["churn"] = lambda kk: churn_uniforms(kk, k)
        root["churn"] = 5
    for stream, fn in streams.items():
        per_seed = []
        for seed in range(kw["seeds"]):
            keys = jax.random.split(jax.random.PRNGKey(seed), 6)
            per_seed.append(jax.vmap(fn)(
                jax.random.split(keys[root[stream]], r)))
        out[f"{name}:{stream}"] = np.stack(per_seed, 1)   # [R, seeds, ...]
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's round times and flags of every case on 4 devices, and the
    random inputs its sweep drew."""
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
    out = dict(np.load(tmp / "out.npz"))
    tables = {name: {key.split(":", 1)[1]: v for key, v in out.items()
                     if key.startswith(name + ":")
                     and key.split(":", 1)[1] not in ("rts", "flags")}
              for name in CASES}
    return out, tables


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """The port's replayed sweeps on 1 process (no group) and on every rank
    of 2 and 4 gloo ranks."""
    _, tables = jax_runs
    runs = {1: [replayed_sweeps(0, 1, CASES, tables)]}
    for world in (2, 4):
        runs[world] = run_ranks(replayed_sweeps, world,
                                tmp_path_factory.mktemp(f"replay{world}"),
                                CASES, tables)
    return runs


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_sweep_matches_jax_sharded_sweep(jax_runs, port_runs, name,
                                                 world):
    out, _ = jax_runs
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
