"""The port's FedAvg combine and aggregation against the JAX package's, on
the CPU: ``kernels/ref.fedavg_combine_ref`` (the CUDA kernel's plain
version, which ``kernels/ops.fedavg_combine`` runs for CPU tensors) against
the Pallas kernel in interpret mode, ``fl/engine.masked_fedavg`` against
``_masked_fedavg`` with the row guard, and ``fl/aggregation``'s list API.

Tolerances: float32 within rtol 1e-6 (atol 1e-6; XLA's einsum and the
port's left-to-right sum round differently), bfloat16 within rtol 2e-2
(atol 1e-3), as the JAX package's own kernel test states them.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py (phase 6), bitwise in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fl import aggregation as jagg  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.kernels import fedavg as jfedavg  # noqa: E402
from repro_torch.fl import aggregation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=1e-3)}


def _rows(rng, shape, dtype):
    """Standard-normal rows rounded to ``dtype`` once, as numpy float32."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(TORCH_DTYPES[dtype]).float().numpy()


@pytest.mark.parametrize("c,n", [(2, 8192), (5, 50_000), (10, 8192 * 3 + 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_combine_matches_pallas_kernel(c, n, dtype):
    rng = np.random.default_rng(c + n)
    x = _rows(rng, (c, n), dtype)
    w = rng.dirichlet(np.ones(c)).astype(np.float32)
    want = jfedavg.fedavg_combine(jnp.asarray(x, JAX_DTYPES[dtype]),
                                  jnp.asarray(w), interpret=True)
    got = ops.fedavg_combine(torch.from_numpy(x).to(TORCH_DTYPES[dtype]),
                             torch.from_numpy(w))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (n,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_combine_equals_separate_combines(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rows(rng, (3, 4, 1000), dtype)).to(
        TORCH_DTYPES[dtype])
    w = torch.from_numpy(rng.random((3, 4), np.float32))
    w[1, 2] = 0.0
    got = ref.fedavg_combine_ref(x, w)
    assert got.shape == (3, 1000)
    for g in range(3):
        assert torch.equal(got[g], ref.fedavg_combine_ref(x[g], w[g]))


def test_identical_rows_give_the_row_back():
    rng = np.random.default_rng(2)
    row = torch.from_numpy(rng.standard_normal(8192).astype(np.float32))
    x = row.expand(4, -1).contiguous()
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    torch.testing.assert_close(ref.fedavg_combine_ref(x, w), row, rtol=1e-6,
                               atol=1e-6)


def _guard_case(rng, c=6, n=3000):
    x = rng.standard_normal((c, n)).astype(np.float32)
    x[1, 17] = np.nan                 # non-finite row
    x[3] *= 1e9                       # norm-exploding row
    w = np.array([3, 5, 2, 4, 0, 6], np.float32)
    return x, w


def test_masked_fedavg_guard_matches_jax():
    x, w = _guard_case(np.random.default_rng(3))
    javg, jw, jrej = jengine._masked_fedavg({"p": jnp.asarray(x)},
                                            jnp.asarray(w), False, guard=True)
    avg, w_ok, n_rej = engine.masked_fedavg(torch.from_numpy(x.copy())[None],
                                            torch.from_numpy(w)[None],
                                            guard=True)
    assert int(n_rej[0]) == int(jrej) == 2
    np.testing.assert_array_equal(w_ok[0].numpy(), np.asarray(jw))
    assert np.isfinite(avg.numpy()).all()
    np.testing.assert_allclose(avg[0].numpy(), np.asarray(javg["p"]),
                               **TOL["float32"])
    # without the guard the same combine is the unguarded JAX one
    clean = np.nan_to_num(x, nan=0.0)[[0, 2, 4, 5]]
    cw = w[[0, 2, 4, 5]]
    np.testing.assert_allclose(
        engine.masked_fedavg(torch.from_numpy(clean)[None],
                             torch.from_numpy(cw)[None])[0].numpy(),
        np.asarray(jengine._masked_fedavg({"p": jnp.asarray(clean)},
                                          jnp.asarray(cw), False)["p"]),
        **TOL["float32"])


def _client_trees(rng, n_clients=4):
    return [{"a": rng.standard_normal((3, 5)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
            for _ in range(n_clients)]


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("guard", [False, True])
def test_aggregation_fedavg_matches_jax(use_kernel, guard):
    rng = np.random.default_rng(4)
    trees = _client_trees(rng)
    if guard:
        trees[2]["a"][0, 0] = np.inf
    weights = [120.0, 340.0, 55.0, 980.0]
    want = jagg.fedavg([{k: jnp.asarray(v) for k, v in t.items()}
                        for t in trees], weights, use_kernel=False,
                       guard=guard)
    got = aggregation.fedavg([_port(t) for t in trees], weights,
                             use_kernel=use_kernel, guard=guard)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL["float32"])
    assert aggregation.update_ok(_port(trees[0]))
    assert aggregation.update_ok(_port(trees[2])) == (not guard)


def test_aggregation_guard_rejecting_all_raises():
    rng = np.random.default_rng(5)
    trees = [_port(t) for t in _client_trees(rng, 2)]
    for t in trees:
        t["b"][0] = float("nan")
    with pytest.raises(ValueError, match="rejected all"):
        aggregation.fedavg(trees, [1.0, 1.0], guard=True)


def test_fedavg_delta_matches_jax():
    rng = np.random.default_rng(6)
    trees = _client_trees(rng, 3)
    glob = _client_trees(rng, 1)[0]
    weights = [2.0, 3.0, 5.0]
    want = jagg.fedavg_delta({k: jnp.asarray(v) for k, v in glob.items()},
                             [{k: jnp.asarray(v) for k, v in t.items()}
                              for t in trees], weights, server_lr=0.5)
    got = aggregation.fedavg_delta(_port(glob), [_port(t) for t in trees],
                                   weights, server_lr=0.5)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL["float32"])
