"""The port's learning-coupled engine (repro_torch.fl.engine) against the
JAX package's ``fl.engine``, on the CPU.

  1. the client update against ``make_client_update`` on the same epoch
     orders (the argsort idiom with padded shards, and the native
     permutation of full shards);
  2. one ``train_round`` against ``_train_round`` for both cohorts, and with
     failure flags holding a corrupt and a crashed slot;
  3. ``run_replay`` against the JAX ``run_replay`` on the same presampled
     candidates, times and epoch orders, 3 policies x both cohorts x 3
     rounds;
  4. ``accuracy_sweep(device="cpu")`` end to end, the fault counts of a
     flaky-clients sweep, and the entry points' refusals.

Both packages start from the JAX package's initial weights.  The parity
configs switch BatchNorm off, as tests/test_fl_engine.py does: train-mode
batch statistics amplify one-ulp differences of summation order under SGD
at lr 0.25, so with BatchNorm on only the first round is compared (within a
relative L2 of 5e-4).  Tolerances: selections, round times, elapsed times,
fault counts exact; accuracy within 1e-3; parameters after a round within a
relative L2 of 1e-6 with BatchNorm off.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (SMALL_CNN, cnn_configs, jax_orders,  # noqa: E402
                           rel_l2)

from repro.core import bandit_jax  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.sim.scenarios import get_scenario as jget_scenario  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.sim import engine as sim  # noqa: E402
from repro_torch.utils.trees import FlatSpec, flatten  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

RUN = dict(s_round=3, epochs=2, batch_size=10)
TASK = dict(n_clients=12, n_train=600, n_test=400, eval_batch=200,
            max_samples=40, batch_size=10)
N_REQ, ROUNDS = 6, 3
POLICIES = ("fedcs", "elementwise_ucb", "discounted_ucb")


@pytest.fixture(scope="module")
def tasks():
    """(JAX task, port task) of the same data and initial weights."""
    jcfg, _ = cnn_configs(SMALL_CNN, False)
    jt = jengine.make_cnn_task("paper-baseline", cfg=jcfg, **TASK)
    p0 = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jt.params0))
    tt = engine.make_cnn_task("paper-baseline",
                              cfg=cnn_configs(SMALL_CNN, False)[1],
                              params0=p0, device="cpu", **TASK)
    return jt, tt


@pytest.fixture(scope="module")
def presample(tasks):
    """The JAX package's legacy presample of 3 rounds, as numpy, with the
    epoch orders its perm keys give every client."""
    jt, _ = tasks
    bits = jnp.float32(8.0 * 4 * jcnn.param_count(jt.params0))
    pre = jax.tree.map(np.asarray, jengine._presample(
        jt.env, jget_scenario("paper-baseline"), 0, n_rounds=ROUNDS,
        n_req=N_REQ, eta=jnp.float32(1.5), model_bits=bits, fluctuate=True))
    native = jengine._native_perm_auto(jt)
    counts, cap = np.asarray(jt.part_count), jt.part_idx.shape[1]
    pre["orders"] = np.stack([
        jax_orders(pre["perm_keys"][r], np.arange(jt.n_clients), counts, cap,
                   RUN["epochs"], native) for r in range(ROUNDS)])
    return pre


def _jax_flat(tree, spec):
    return flatten(convert.cnn_params_from_jax(jax.tree.map(np.asarray,
                                                            tree)), spec)


# ---------------------------------------------------------------------------
# 1. the client update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [False, True], ids=["argsort", "native"])
@pytest.mark.parametrize("bn", [False, True], ids=["bn-off", "bn-on"])
def test_client_update_matches_jax(tasks, native, bn):
    jt, tt = tasks
    jcfg, cfg = cnn_configs(SMALL_CNN, bn)
    clients = np.array([4, 9, 1, 7])
    counts = (np.full(4, 40, np.int32) if native
              else np.array([40, 25, 13, 31], np.int32))
    cap, lr, key = 40, np.float32(0.25), jax.random.PRNGKey(5)
    idx = np.asarray(jt.part_idx)[clients]
    cu = jengine.make_client_update(functools.partial(jcnn.loss_fn, cfg=jcfg),
                                    epochs=2, batch_size=10,
                                    native_perm=native)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(len(clients)))
    want = jax.jit(jax.vmap(cu, in_axes=(None, None, None, 0, 0, None, 0)))(
        jt.params0, jt.train_x, jt.train_y, jnp.asarray(idx),
        jnp.asarray(counts), lr, keys)

    spec = FlatSpec.of_tree(tt.params0)
    rows = flatten(tt.params0, spec).repeat(len(clients), 1)
    orders = jax_orders(key, np.arange(len(clients)), counts, cap, 2, native)
    engine.make_client_update(cfg, epochs=2, batch_size=10)(
        rows, spec, tt.train_x, tt.train_y, torch.as_tensor(idx).long(),
        torch.as_tensor(counts).long(), float(lr), torch.as_tensor(orders))
    tol = 5e-4 if bn else 1e-6
    for m in range(len(clients)):
        one = jax.tree.map(lambda x: x[m], want)
        assert rel_l2(rows[m].numpy(), _jax_flat(one, spec).numpy()) < tol


def test_draw_orders_put_padding_last():
    count = torch.tensor([5, 8, 0, 3])
    gen = torch.Generator().manual_seed(0)
    order = engine.draw_orders(gen, 2, count, 3, 8)
    assert order.shape == (2, 4, 3, 8)
    assert torch.equal(order.sort(-1).values,
                       torch.arange(8).expand_as(order))
    for k, c in enumerate(count.tolist()):
        assert (order[:, k, :, :c] < c).all()


# ---------------------------------------------------------------------------
# 2. one train round
# ---------------------------------------------------------------------------

TRAIN_CASES = [("all", False, False), ("selected", False, False),
               ("all", True, False), ("selected", True, False),
               ("selected", False, True)]


@pytest.mark.parametrize("cohort,failure,bn", TRAIN_CASES,
                         ids=["all", "selected", "all-flags",
                              "selected-flags", "selected-bn"])
def test_train_round_matches_jax(tasks, presample, one_thread, cohort,
                                 failure, bn):
    # BatchNorm carries the convolutions' float32 rounding, which depends
    # on how many threads split their sums: its limit was read at the
    # process's own thread count, so the BN case runs there
    torch.set_num_threads(one_thread if bn else 1)
    try:
        _train_round_matches_jax(tasks, presample, cohort, failure, bn)
    finally:
        torch.set_num_threads(1)


def _train_round_matches_jax(tasks, presample, cohort, failure, bn):
    jt, tt = tasks
    jcfg, cfg = cnn_configs(SMALL_CNN, bn)
    native = jengine._native_perm_auto(jt)
    sel = np.array([4, 9, 1], np.int32)
    flags = (np.array([bandit.FLAG_CORRUPT, bandit.FLAG_CRASH,
                       bandit.FLAG_OK], np.int32) if failure else None)
    cu = jengine.make_client_update(functools.partial(jcnn.loss_fn, cfg=jcfg),
                                    epochs=2, batch_size=10,
                                    native_perm=native)
    lr = np.float32(0.25)
    want = jengine._train_round(
        jt.params0, jnp.asarray(sel), jt, lr, presample["perm_keys"][0],
        client_update=cu, cohort=cohort, use_kernel=False,
        flags=None if flags is None else jnp.asarray(flags))

    spec = FlatSpec.of_tree(tt.params0)
    got = engine.train_round(
        flatten(tt.params0, spec)[None], torch.as_tensor(sel)[None], tt,
        float(lr), torch.as_tensor(presample["orders"][0])[None], spec,
        client_update=engine.make_client_update(cfg, epochs=2,
                                                batch_size=10),
        cohort=cohort,
        flags=None if flags is None else torch.as_tensor(flags)[None])
    if failure:
        (want, jrej), (got, rej) = want, got
        assert int(rej[0]) == int(jrej) == 1
    err = rel_l2(got[0].numpy(), _jax_flat(want, spec).numpy())
    assert err < (5e-4 if bn else 1e-6)


def test_all_failed_round_keeps_the_model(tasks, presample):
    _, tt = tasks
    _, cfg = cnn_configs(SMALL_CNN, False)
    spec = FlatSpec.of_tree(tt.params0)
    p0 = flatten(tt.params0, spec)[None]
    flags = torch.tensor([[bandit.FLAG_CORRUPT, bandit.FLAG_CRASH,
                           bandit.FLAG_DEADLINE]])
    got, rej = engine.train_round(
        p0, torch.tensor([[4, 9, 1]]), tt, 0.25,
        torch.as_tensor(presample["orders"][0])[None], spec,
        client_update=engine.make_client_update(cfg, epochs=2,
                                                batch_size=10),
        cohort="selected", flags=flags)
    assert int(rej[0]) == 1
    assert torch.equal(got, p0)


# ---------------------------------------------------------------------------
# 3. run_replay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_replays(tasks, presample):
    jt, _ = tasks
    jcfg, _ = cnn_configs(SMALL_CNN, False)
    return {(p, c): jengine.run_replay(
                jt, np.float32(bandit_jax.DEFAULT_HYPERS[p]),
                presample["cand_masks"], presample["t_ud"], presample["t_ul"],
                presample["pol_keys"], presample["perm_keys"], policy=p,
                cohort=c, cfg=jcfg, **RUN)
            for p in POLICIES for c in ("all", "selected")}


def _port_replay(tt, pre, policy, cohort, rounds=ROUNDS):
    return engine.run_replay(
        tt, bandit.DEFAULT_HYPERS[policy], pre["cand_masks"][:rounds],
        pre["t_ud"][:rounds], pre["t_ul"][:rounds], pre["orders"][:rounds],
        policy=policy, cohort=cohort, cfg=cnn_configs(SMALL_CNN, False)[1],
        **RUN)


@pytest.mark.parametrize("cohort", ["all", "selected"])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_replay_matches_jax(tasks, presample, jax_replays, policy,
                                cohort):
    jt, tt = tasks
    want = jax_replays[(policy, cohort)]
    got = _port_replay(tt, presample, policy, cohort)
    np.testing.assert_array_equal(got["selected"], want["selected"])
    np.testing.assert_array_equal(got["round_times"], want["round_times"])
    np.testing.assert_array_equal(got["elapsed"], want["elapsed"])
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    # the global model after round 1 against _train_round on round 1
    jcfg, _ = cnn_configs(SMALL_CNN, False)
    cu = jengine.make_client_update(functools.partial(jcnn.loss_fn, cfg=jcfg),
                                    epochs=2, batch_size=10,
                                    native_perm=jengine._native_perm_auto(jt))
    p1 = jengine._train_round(
        jt.params0, jnp.asarray(want["selected"][0]), jt,
        jnp.float32(0.25), presample["perm_keys"][0], client_update=cu,
        cohort=cohort, use_kernel=False)
    spec = FlatSpec.of_tree(tt.params0)
    one = _port_replay(tt, presample, policy, cohort, rounds=1)
    assert rel_l2(flatten(one["params"], spec).numpy(),
                  _jax_flat(p1, spec).numpy()) < 1e-6


# ---------------------------------------------------------------------------
# 4. the sweep
# ---------------------------------------------------------------------------

def _sweep(tt, **kw):
    return engine.accuracy_sweep(task=tt, cfg=cnn_configs(SMALL_CNN,
                                                          False)[1],
                                 s_round=3, frac_request=0.5, epochs=1,
                                 batch_size=10, device="cpu", **kw)


def test_accuracy_sweep_on_cpu(tasks):
    _, tt = tasks
    res = _sweep(tt, seeds=2, n_rounds=4)
    p, s, r = len(bandit.POLICY_NAMES), 2, 4
    assert res.policies == tuple(bandit.POLICY_NAMES)
    assert res.round_times.shape == (p, s, r)
    assert res.accuracy.shape == (p, s, r)
    assert res.selected.shape == (p, s, r, 3)
    assert res.flags is None
    assert np.all(res.round_times > 0)
    assert np.isfinite(res.accuracy).all()
    assert np.all((res.accuracy >= 0) & (res.accuracy <= 1))
    assert np.all(np.diff(res.elapsed, axis=-1) > 0)
    assert np.all(np.isinf(res.toa(2.0)))
    np.testing.assert_array_equal(res.toa(0.0), res.elapsed[..., 0])
    assert len(res.summary().splitlines()) == p + 1
    # every policy of a seed saw the same candidates: the oracle's first
    # round picks from them as fedcs's does, both cold
    assert np.all(res.selected >= 0) and np.all(res.selected < 12)


def test_cohorts_of_the_sweep_agree(tasks):
    _, tt = tasks
    kw = dict(policies=("elementwise_ucb", "random"), seeds=(0, 3),
              n_rounds=3)
    a, b = _sweep(tt, cohort="all", **kw), _sweep(tt, cohort="selected", **kw)
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(a.round_times, b.round_times)
    np.testing.assert_allclose(a.accuracy, b.accuracy, atol=1e-3)


@pytest.mark.parametrize("scen", ["paper-baseline", "flaky-clients"])
def test_fused_and_unfused_sweeps_agree(tasks, scen):
    """``fused=False`` (the JAX package's argument) runs the unfused mask
    pipeline: the same selections, flags and models as the fused round;
    ``use_kernel=False`` and ``fast_perm`` are accepted on the CPU, and
    ``use_kernel=True`` asks for the card."""
    _, tt = tasks
    kw = dict(policies=("elementwise_ucb", "random", "naive_ucb"),
              seeds=(0, 3), n_rounds=3, cohort="selected",
              deadline=2.0 if scen == "flaky-clients" else None)
    engine_kw = dict(task=tt, cfg=cnn_configs(SMALL_CNN, False)[1],
                     s_round=3, frac_request=0.5, epochs=1, batch_size=10,
                     device="cpu")
    a = engine.accuracy_sweep(scen, **kw, **engine_kw)
    b = engine.accuracy_sweep(scen, fused=False, use_kernel=False,
                              fast_perm=True, **kw, **engine_kw)
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_allclose(a.round_times, b.round_times, rtol=1e-6)
    np.testing.assert_array_equal(a.accuracy, b.accuracy)
    if scen == "flaky-clients":
        np.testing.assert_array_equal(a.flags, b.flags)
    with pytest.raises(ValueError, match="use_kernel"):
        engine.accuracy_sweep(scen, use_kernel=True, **kw, **engine_kw)


def test_flaky_sweep_fault_counts_partition(tasks):
    _, tt = tasks
    res = engine.accuracy_sweep(
        "flaky-clients", task=tt, cfg=cnn_configs(SMALL_CNN, False)[1],
        policies=("fedcs", "elementwise_ucb"), seeds=2, n_rounds=4,
        s_round=3, frac_request=0.5, epochs=1, batch_size=10,
        cohort="selected", deadline=2.0, device="cpu")
    assert res.flags.shape == (2, 2, 4, 3)
    fc = res.fault_counts()
    parts = sum(fc[k] for k in ("ok", "crashed", "churned",
                                "deadline_missed", "corrupt"))
    np.testing.assert_array_equal(parts, fc["dispatched"])
    assert fc["deadline_missed"].sum() > 0
    assert np.isfinite(res.accuracy).all()
    with pytest.raises(ValueError, match="deadline"):
        _sweep(tt, seeds=1, n_rounds=1).fault_counts()


def test_entry_points_refuse(tasks):
    """The sweep runs on the card unless asked for the CPU, takes a task or
    task_kwargs but not both, refuses S > K, an unknown shard mode and a
    ``chunk_rounds`` that does not divide ``n_rounds`` (``devices`` and
    ``shard="clients"`` are accepted now: tests/test_torch_distributed.py
    holds them to the flat sweep)."""
    _, tt = tasks
    if torch.cuda.is_available():
        assert sim.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.accuracy_sweep(policies=("fedcs",), seeds=1, n_rounds=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.make_cnn_task(n_clients=4, n_train=10, n_test=10)
    with pytest.raises(ValueError, match="not divisible by chunk_rounds=2"):
        _sweep(tt, seeds=1, n_rounds=1, chunk_rounds=2)
    with pytest.raises(ValueError, match="shard mode"):
        _sweep(tt, seeds=1, n_rounds=1, shard="rows")
    with pytest.raises(ValueError, match="task_kwargs"):
        _sweep(tt, seeds=1, n_rounds=1, n_train=10)
    with pytest.raises(ValueError, match="exceeds"):
        engine.accuracy_sweep(task=tt, s_round=13, device="cpu")


def test_perm_stream_leaves_earlier_streams_unchanged():
    """The "perm" stream is appended last, so every stream of the time-only
    sweep draws what it drew before the FL slice added it."""
    gens = sim.make_generators((0, 1), "cpu")
    children = np.random.SeedSequence([0, 1]).spawn(6)
    for name, child in zip(sim.STREAMS[:6], children):
        want = torch.Generator().manual_seed(int(child.generate_state(1)[0]))
        assert torch.equal(torch.rand(5, generator=gens[name]),
                           torch.rand(5, generator=want)), name
    assert sim.STREAMS[-1] == "perm"
