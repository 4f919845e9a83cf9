"""How far the port's FL models drift from the JAX package's with BatchNorm
on, against how far the JAX package drifts from itself when every initial
weight moves by one ulp.  Prints one line per tick of the async FL twin
(ticks 2-4, tests/test_torch_async_fl.py's config) and per round of the
sync replay (rounds 1-4, tests/test_torch_fl_engine.py's config with
BatchNorm on): the relative L2 of the global parameters, port against
JAX and JAX against JAX(+1 ulp).  Where the second is as large as the
first, the drift is train-mode batch statistics amplifying rounding, not
a fault of the port.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_bn_drift.py

CPU only, about a minute.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from _torch_parity import (SMALL_CNN, cnn_configs, jax_orders,
                           jax_tick_draws, rel_l2)

from repro.fl import engine as jengine
from repro.models import cnn as jcnn
from repro.sim import async_engine as jae
from repro.sim.scenarios import get_scenario as jget_scenario
from repro_torch import convert
from repro_torch.core import bandit
from repro_torch.fl import engine
from repro_torch.optim.sgd import round_lrs
from repro_torch.sim import async_engine as ae
from repro_torch.utils.trees import FlatSpec, flatten

# tests/test_torch_async_fl.py's config
TASK = dict(n_clients=12, n_train=600, n_test=400, eval_batch=200,
            max_samples=40, batch_size=10)
FIELDS = dict(n_slots=8, buffer_size=2, max_staleness=3, s_dispatch=3,
              n_req=6, arrival_rate=3.0)
RUN = dict(epochs=2, batch_size=10, eta=1.5)
POLICY = "elementwise_ucb"


def _tasks():
    jcfg, tcfg = cnn_configs(SMALL_CNN, True)
    jt = jengine.make_cnn_task("paper-baseline", cfg=jcfg, **TASK)
    p0 = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jt.params0))
    tt = engine.make_cnn_task("paper-baseline", cfg=tcfg, params0=p0,
                              device="cpu", **TASK)
    bumped = jax.tree.map(lambda x: jnp.asarray(np.nextafter(
        np.asarray(x), np.float32(np.inf))), jt.params0)
    return jt, dataclasses.replace(jt, params0=bumped), jcfg, tt, tcfg


def async_twin(jt, jt_ulp, jcfg, tt, tcfg, flat):
    perm = dict(counts=np.asarray(jt.part_count), cap=jt.part_idx.shape[1],
                epochs=RUN["epochs"], native=jengine._native_perm_auto(jt))
    for n in (2, 3, 4):
        kw = dict(n_ticks=n, seed=2, acfg=jae.AsyncConfig(**FIELDS),
                  cfg=jcfg, **RUN)
        want = jengine.async_accuracy_run("paper-baseline", POLICY, task=jt,
                                          **kw)
        ulp = jengine.async_accuracy_run("paper-baseline", POLICY,
                                         task=jt_ulp, **kw)
        draws = jax_tick_draws("paper-baseline", jae.AsyncConfig(**FIELDS), 2,
                               n, TASK["n_clients"], perm=perm)
        got = engine.async_accuracy_run(
            "paper-baseline", POLICY, n_ticks=n, task=tt, cfg=tcfg,
            acfg=ae.AsyncConfig(**FIELDS), draws=draws, device="cpu", **RUN)
        ref = flat(want["params"], True)
        print(f"async twin, BN on, tick {n}: port-vs-JAX "
              f"{rel_l2(flat(got['params']), ref):.3e}, JAX-vs-JAX(+1 ulp) "
              f"{rel_l2(flat(ulp['params'], True), ref):.3e}", flush=True)


def sync_replay(jt, jt_ulp, jcfg, tt, tcfg, flat, n_rounds=4):
    run = dict(s_round=3, epochs=2, batch_size=10)
    bits = jnp.float32(8.0 * 4 * jcnn.param_count(jt.params0))
    pre = jax.tree.map(np.asarray, jengine._presample(
        jt.env, jget_scenario("paper-baseline"), 0, n_rounds=n_rounds,
        n_req=6, eta=jnp.float32(1.5), model_bits=bits, fluctuate=True))
    native = jengine._native_perm_auto(jt)
    counts, cap = np.asarray(jt.part_count), jt.part_idx.shape[1]
    orders = np.stack([jax_orders(pre["perm_keys"][r],
                                  np.arange(jt.n_clients), counts, cap, 2,
                                  native) for r in range(n_rounds)])
    cu = jengine.make_client_update(functools.partial(jcnn.loss_fn, cfg=jcfg),
                                    epochs=2, batch_size=10,
                                    native_perm=native)
    lrs = round_lrs(n_rounds)
    pa, pb = jt.params0, jt_ulp.params0
    for r in range(1, n_rounds + 1):
        got = engine.run_replay(
            tt, bandit.DEFAULT_HYPERS[POLICY], pre["cand_masks"][:r],
            pre["t_ud"][:r], pre["t_ul"][:r], orders[:r], policy=POLICY,
            cohort="selected", cfg=tcfg, **run)
        sel = jnp.asarray(got["selected"][r - 1])

        def step(p):
            return jengine._train_round(
                p, sel, jt, jnp.float32(lrs[r - 1]), pre["perm_keys"][r - 1],
                client_update=cu, cohort="selected", use_kernel=False)
        pa, pb = step(pa), step(pb)
        ref = flat(pa, True)
        print(f"sync replay, BN on, round {r}: port-vs-JAX "
              f"{rel_l2(flat(got['params']), ref):.3e}, JAX-vs-JAX(+1 ulp) "
              f"{rel_l2(flat(pb, True), ref):.3e}", flush=True)


def main():
    jt, jt_ulp, jcfg, tt, tcfg = _tasks()
    spec = FlatSpec.of_tree(tt.params0)

    def flat(params, from_jax=False):
        if from_jax:
            params = convert.cnn_params_from_jax(
                jax.tree.map(np.asarray, params))
        return flatten(params, spec).numpy()
    async_twin(jt, jt_ulp, jcfg, tt, tcfg, flat)
    sync_replay(jt, jt_ulp, jcfg, tt, tcfg, flat)


if __name__ == "__main__":
    main()
