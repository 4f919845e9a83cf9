"""``fl.engine.run_host_reference`` of the port — the host-loop twin of
``run_replay`` (one client at a time through ``fl/server.LocalTrainer`` and
``fl/aggregation.fedavg``, one SGD step a minibatch) — against the JAX
package's ``run_host_reference`` on the same draws and against the port's
own ``run_replay``.

The setting is tests/test_fl_engine.py's: its small CNN with BatchNorm
off, 12 clients, S = 3 of 6 requested, 2 local epochs of batch 10.  JAX's
``pre`` (candidate masks, times, perm keys) is converted once: each
round's epoch orders drawn from its perm key with the JAX package's idiom
(``_torch_parity.jax_orders``).  Selections, round times and elapsed
times must be equal, accuracy within 1e-3 (float32 orders of the two
packages' SGD differ in ulps).  Whether the reference learns is not
asserted: the JAX reference does not learn either in 8 rounds of this
setting (0.1825).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _torch_parity import SMALL_CNN, cnn_configs, jax_orders  # noqa: E402

from repro.core import bandit_jax  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

RUN = dict(s_round=3, epochs=2, batch_size=10)
TASK = dict(n_clients=12, n_train=600, n_test=400, eval_batch=200,
            max_samples=40, batch_size=10)
ROUNDS = 4
POLICIES = ("fedcs", "elementwise_ucb")


@pytest.fixture(scope="module")
def tasks():
    """(JAX task, port task) of the same data and initial weights."""
    jcfg, tcfg = cnn_configs(SMALL_CNN, False)
    jt = jengine.make_cnn_task("paper-baseline", cfg=jcfg, **TASK)
    p0 = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jt.params0))
    tt = engine.make_cnn_task("paper-baseline", cfg=tcfg, params0=p0,
                              device="cpu", **TASK)
    return jt, tt


@pytest.fixture(scope="module")
def runs(tasks):
    """Per policy: JAX's host reference and its ``pre`` converted."""
    jt, _ = tasks
    jcfg, _ = cnn_configs(SMALL_CNN, False)
    native = jengine._native_perm_auto(jt)
    counts, cap = np.asarray(jt.part_count), jt.part_idx.shape[1]
    out = {}
    for policy in POLICIES:
        host = jengine.run_host_reference(
            jt, policy=policy, seed=0, n_rounds=ROUNDS, frac_request=0.5,
            cfg=jcfg, **RUN)
        pre = jax.tree.map(np.asarray, host["pre"])
        conv = {k: pre[k] for k in ("cand_masks", "t_ud", "t_ul")}
        conv["orders"] = np.stack([
            jax_orders(pre["perm_keys"][r], np.arange(jt.n_clients), counts,
                       cap, RUN["epochs"], native) for r in range(ROUNDS)])
        out[policy] = (host, conv)
    return out


def _port_host(tt, pre, policy):
    return engine.run_host_reference(
        tt, pre, policy=policy, cfg=cnn_configs(SMALL_CNN, False)[1], **RUN)


def _same_run(got, want):
    np.testing.assert_array_equal(got["selected"], want["selected"])
    np.testing.assert_array_equal(got["round_times"], want["round_times"])
    np.testing.assert_array_equal(got["elapsed"], want["elapsed"])
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)


@pytest.mark.parametrize("policy", POLICIES)
def test_host_reference_matches_jax(tasks, runs, policy):
    _, tt = tasks
    host, pre = runs[policy]
    got = _port_host(tt, pre, policy)
    _same_run(got, {k: np.asarray(host[k]) for k in
                    ("selected", "round_times", "elapsed", "accuracy")})


@pytest.mark.parametrize("policy", POLICIES)
def test_host_reference_matches_port_replay(tasks, runs, policy):
    _, tt = tasks
    _, pre = runs[policy]
    got = _port_host(tt, pre, policy)
    want = engine.run_replay(
        tt, bandit.DEFAULT_HYPERS[policy], pre["cand_masks"], pre["t_ud"],
        pre["t_ul"], pre["orders"], policy=policy,
        cfg=cnn_configs(SMALL_CNN, False)[1], **RUN)
    _same_run(got, want)
    assert np.isclose(float(bandit.DEFAULT_HYPERS[policy]),
                      float(bandit_jax.DEFAULT_HYPERS[policy]))


def test_host_reference_refuses_churn(tasks, runs):
    """A scenario with churn is refused with the JAX package's message."""
    jt, tt = tasks
    _, pre = runs["fedcs"]
    from repro.sim.scenarios import get_scenario as jget
    from repro_torch.sim.scenarios import get_scenario
    assert get_scenario("client-churn").churn_prob > 0.0
    with pytest.raises(ValueError) as want:
        jengine.run_host_reference(jt, scenario=jget("client-churn"),
                                   n_rounds=1)
    with pytest.raises(ValueError) as got:
        engine.run_host_reference(tt, pre, scenario="client-churn")
    assert str(got.value) == str(want.value)
