"""The port's learning-coupled async twin (repro_torch.fl.engine.
``async_accuracy_run``) against the JAX package's, on the CPU, on the small
CNN of tests/test_fl_engine.py: the same per-tick draws (JAX's
``tick_keys``, the clients' epoch orders from its ``"perm"`` keys) and the
same initial weights.

Both cases run 4 ticks.  Tolerances: selections and counters exact, round
times within rtol 1e-6 over the 4 ticks; with BatchNorm off, global
parameters within a relative L2 of 1e-5 and accuracy within 1e-3 after 4
ticks; with it on, the same after 2 ticks within 1e-4.  Train-mode batch
statistics amplify one-ulp differences under SGD (tests/test_torch_fl_
engine.py): with BatchNorm on the port's distance to JAX grows from
8.7e-6 at tick 2 to 1.5e-2 at tick 3 and 0.17 at tick 4, and JAX's own
distance to a JAX run whose initial weights moved by one ulp is
7.3e-5, 4.6e-2 and 0.19, so past tick 2 the parameters show rounding and
not the twin.  The FedBuff sum through the plain ``fedavg_combine``
against JAX's ``einsum`` within rtol 1e-6 of the sum of the terms'
magnitudes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (SMALL_CNN, cnn_configs,  # noqa: E402
                           jax_tick_draws, rel_l2)

from repro.fl import engine as jengine  # noqa: E402
from repro.sim import async_engine as jae  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sim import async_engine as ae  # noqa: E402
from repro_torch.utils.trees import FlatSpec, flatten  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TASK = dict(n_clients=12, n_train=600, n_test=400, eval_batch=200,
            max_samples=40, batch_size=10)
FIELDS = dict(n_slots=8, buffer_size=2, max_staleness=3, s_dispatch=3,
              n_req=6, arrival_rate=3.0)
RUN = dict(epochs=2, batch_size=10, eta=1.5)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_serving_loops():
    yield
    jax.clear_caches()


def _tasks(bn: bool):
    jcfg, tcfg = cnn_configs(SMALL_CNN, bn)
    jt = jengine.make_cnn_task("paper-baseline", cfg=jcfg, **TASK)
    p0 = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jt.params0))
    tt = engine.make_cnn_task("paper-baseline", cfg=tcfg, params0=p0,
                              device="cpu", **TASK)
    return (jt, jcfg), (tt, tcfg)


def _twins(bn, n_ticks, policy="elementwise_ucb", seed=2):
    """(JAX's run, the port's run on JAX's draws) of ``n_ticks`` ticks."""
    (jt, jcfg), (tt, tcfg) = _tasks(bn)
    want = jengine.async_accuracy_run(
        "paper-baseline", policy, n_ticks=n_ticks, seed=seed,
        acfg=jae.AsyncConfig(**FIELDS), task=jt, cfg=jcfg, **RUN)
    perm = dict(counts=np.asarray(jt.part_count), cap=jt.part_idx.shape[1],
                epochs=RUN["epochs"], native=jengine._native_perm_auto(jt))
    draws = jax_tick_draws("paper-baseline", jae.AsyncConfig(**FIELDS), seed,
                           n_ticks, TASK["n_clients"], perm=perm)
    got = engine.async_accuracy_run(
        "paper-baseline", policy, n_ticks=n_ticks, acfg=ae.AsyncConfig(
            **FIELDS), task=tt, cfg=tcfg, draws=draws, device="cpu", **RUN)
    return want, got, FlatSpec.of_tree(tt.params0)


@pytest.mark.parametrize("bn,params_at,limit", [(False, 4, 1e-5),
                                                (True, 2, 1e-4)],
                         ids=["bn-off", "bn-on"])
def test_async_twin_matches_jax(bn, params_at, limit):
    want, got, spec = _twins(bn, 4)
    for name in ("selected", "admitted", "aggregated", "dropped",
                 "buffered"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["aggregated"].sum() > 0
    np.testing.assert_allclose(got["dt"], want["dt"], rtol=1e-6, atol=0)
    assert int(got["state"].n_aggregated) == int(want["state"].n_aggregated)
    if params_at < 4:
        want, got, spec = _twins(bn, params_at)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    jp = flatten(convert.cnn_params_from_jax(
        jax.tree.map(np.asarray, want["params"])), spec)
    assert rel_l2(flatten(got["params"], spec).numpy(), jp.numpy()) < limit


def test_fedbuff_combine_matches_jax_einsum():
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((5, 4099)).astype(np.float32)
    sw = rng.uniform(0, 900, 5).astype(np.float32)
    sw[3] = 0.0                                  # a fill slot's weight
    want = np.asarray(jnp.einsum("s,sn->n", jnp.asarray(sw),
                                 jnp.asarray(buf)))
    got = ops.fedavg_combine(torch.from_numpy(buf), torch.from_numpy(sw))
    # rtol against the sum of the terms' magnitudes: two summation orders
    # of signed terms differ by a few ulps of that, not of a cancelled sum
    scale = np.abs(sw[:, None] * buf).sum(0)
    assert np.max(np.abs(got.numpy() - want) / scale) < 1e-6


def test_async_twin_on_its_own_draws_and_refusals():
    _, (tt, tcfg) = _tasks(False)
    kw = dict(task=tt, cfg=tcfg, n_ticks=3, acfg=ae.AsyncConfig(**FIELDS),
              device="cpu", **RUN)
    out = engine.async_accuracy_run("paper-baseline", "fedcs", seed=4,
                                    fast_perm=True, **kw)
    again = engine.async_accuracy_run("paper-baseline", "fedcs", seed=4,
                                      **kw)
    assert np.isfinite(out["accuracy"]).all()
    assert (np.diff(out["elapsed"]) > 0).all()
    np.testing.assert_array_equal(out["selected"], again["selected"])
    np.testing.assert_array_equal(out["accuracy"], again["accuracy"])
    assert (out["admitted"].cumsum() == out["aggregated"].cumsum()
            + out["dropped"].cumsum() + out["buffered"]).all()
    with pytest.raises(ValueError, match="failure layer"):
        engine.async_accuracy_run(
            **{**kw, "acfg": ae.AsyncConfig(**FIELDS, deadline=10.0)})
