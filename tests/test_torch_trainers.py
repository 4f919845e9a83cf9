"""The port's host-loop trainers and training entry point against the JAX
package on the CPU: ``fl/lm_trainer.LmFlTrainer``,
``fl/cnn_trainer.CnnFlTrainer`` and ``launch/train.main``.

- ``LmFlTrainer``, reduced smollm-135m and recurrentgemma-9b (bfloat16
  compute, as the JAX trainer runs them), one round of 2 clients from the
  JAX init: every batch equal; every step's loss within rtol 2e-3 (read up
  to 2.8e-4); the aggregated parameters within a relative L2 of 1e-2 over
  all leaves (read up to 2.7e-3) and each leaf's change over the round
  within 0.25 of JAX's (read up to 0.13).  bfloat16 activations round at
  other places in the two frameworks, and each client takes 4 SGD steps
  at lr 0.5 on them; in float32 one step agrees to 2e-6
  (tests/test_torch_train_step.py).
- ``CnnFlTrainer``, a small CNN on 8x8 images with the JAX trainer's own
  epoch orders fed in: the aggregated parameters over all leaves within a
  relative L2 of 1e-6 with BatchNorm off, two rounds of 2 epochs (read
  7e-8), and of 5e-4 with it on, one round of 1 epoch (read 2.2e-6; with
  2 epochs the gap reads 1.5e-2: train-mode batch statistics amplify
  one-ulp differences of summation order under SGD at lr 0.25, as in
  tests/test_torch_fl_engine.py).
- ``launch/train.main`` time-only: the printed lines equal the JAX
  package's (the wall-clock seconds aside), with failures, a deadline and
  the elastic swap; a stopped and resumed run equals an uninterrupted one
  (selections, elapsed time, statistics, parameters), time-only and
  training.
"""

import functools
import re
import shutil
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from _torch_parity import SMALL_CNN, cnn_configs, jax_orders  # noqa: E402

from repro.fl import cnn_trainer as jcnn_trainer  # noqa: E402
from repro.fl import lm_trainer as jlm_trainer  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.fl import cnn_trainer as tcnn_trainer  # noqa: E402
from repro_torch.fl import lm_trainer as tlm_trainer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32))


def _record_batches(trainer):
    seen = []
    fn = trainer._batch

    def batch(lo, hi):
        out = fn(lo, hi)
        seen.append(np.asarray(out["tokens"]))
        return out
    trainer._batch = batch
    return seen


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b"])
def test_lm_trainer_round_matches_jax(arch):
    n_samples = np.array([300, 500])
    jt = jlm_trainer.LmFlTrainer(arch, 2, n_samples, seed=0)
    init_t = convert.lm_params_from_tree(jax.tree.map(np.asarray, jt.params))
    tt = tlm_trainer.LmFlTrainer(arch, 2, n_samples, seed=0, device="cpu",
                                 params=init_t)
    assert tt.shards == jt.shards
    jb, tb = _record_batches(jt), _record_batches(tt)
    losses = []
    for k in (0, 1):            # one round, client by client
        jp, jw = jt._client_update(jt.params, k, 0)
        tp, tw = tt._client_update(tt.params, k, 0)
        assert tw == jw
        losses.append((tt.last_losses, jt.last_losses))
        if k == 1:
            jt.params = jt._aggregate(jt.params, [(jp0, jw0), (jp, jw)])
            tt.params = tt._aggregate(tt.params, [(tp0, tw0), (tp, tw)])
        jp0, jw0, tp0, tw0 = jp, jw, tp, tw
    assert len(jb) == len(tb) == 8
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    for got, want in losses:
        assert len(got) == len(want) == 4
        np.testing.assert_allclose(got, want, rtol=2e-3)
    for a, b, p0 in zip(tree_leaves(tt.params), jax.tree.leaves(jt.params),
                        tree_leaves(init_t)):
        assert a.dtype == torch.float32
        assert _rel(_np(a) - _np(p0), _np(b) - _np(p0)) <= 0.25
    flat = lambda leaves: np.concatenate([_np(x).ravel() for x in leaves])
    assert _rel(flat(tree_leaves(tt.params)),
                flat(jax.tree.leaves(jt.params))) <= 1e-2
    np.testing.assert_allclose(tt.accuracy(), jt.accuracy(), rtol=2e-2)


@pytest.mark.parametrize("batchnorm,epochs,tol", [(False, 2, 1e-6),
                                                   (True, 1, 5e-4)])
def test_cnn_trainer_round_matches_jax(batchnorm, epochs, tol, monkeypatch):
    jcfg, tcfg = cnn_configs(SMALL_CNN, batchnorm)
    shim = types.SimpleNamespace(
        CnnConfig=lambda: jcfg,
        init=lambda key: jcnn.init(key, jcfg),
        apply=lambda p, x: jcnn.apply(p, x, jcfg))
    monkeypatch.setattr(jcnn_trainer, "cnn", shim)
    monkeypatch.setattr(jcnn_trainer, "make_synthetic_cifar",
                        functools.partial(jcnn_trainer.make_synthetic_cifar,
                                          size=8))
    n_samples = np.array([120, 60, 200, 80])
    kw = dict(seed=3, n_train=600, n_test=100, batch_size=20, epochs=epochs)
    jt = jcnn_trainer.CnnFlTrainer(4, n_samples, **kw)
    cap = int(jt.part_idx.shape[1])
    counts = np.asarray(jt.part_count)

    def orders(rnd, k):
        key = jax.random.fold_in(jt._base_key, rnd)
        return jax_orders(key, [k], [int(counts[k])], cap, kw["epochs"],
                          native=False)[0]
    tt = tcnn_trainer.CnnFlTrainer(
        4, n_samples, cfg=tcfg, orders=orders, device="cpu",
        params=convert.cnn_params_from_jax(jt.params), **kw)
    np.testing.assert_array_equal(tt.part_idx.numpy(),
                                  np.asarray(jt.part_idx))
    np.testing.assert_array_equal(tt.part_count.numpy(), counts)
    for rnd, sel in enumerate(([0, 2, 3], [1, 2])):
        jt.train_round(sel)
        tt.train_round(sel)
        got = convert.cnn_params_to_jax(tt.params)
        err = _rel(np.concatenate([got[layer][leaf].ravel()
                                   for layer, leaves in jt.params.items()
                                   for leaf in leaves]),
                   np.concatenate([np.asarray(x).ravel()
                                   for leaves in jt.params.values()
                                   for x in leaves.values()]))
        assert err <= tol, (rnd, err)
        if batchnorm:           # only the first round, as the engine tests
            break
    assert tt.rounds_done == jt.rounds_done
    acc = tt.accuracy()
    assert 0.0 <= acc <= 1.0


def _lines(capsys):
    out = capsys.readouterr().out
    return [re.sub(r"in \d+s wall", "in -s wall", line)
            for line in out.splitlines()]


@pytest.mark.parametrize("args", [
    "--policy elementwise_ucb --rounds 12",
    "--policy random --rounds 10 --failure-prob 0.2",
    "--policy naive_ucb --rounds 12 --swap-clients 3 --deadline 2000",
    "--policy discounted_ucb --rounds 10 --clients 40 --seed 4"])
def test_train_main_time_only_matches_jax(args, capsys):
    argv = ["--arch", "none"] + args.split()
    jtrain.main(argv)
    want = _lines(capsys)
    out = ttrain.main(argv + ["--device", "cpu"])
    got = _lines(capsys)
    assert got == want
    assert out["trainer"] is None and len(out["round_s"]) == len(
        out["server"].history)
    if "--swap-clients" in args:
        assert sum("[elastic]" in line for line in got) == 4


def _run(tmp_path, extra, capsys):
    out = ttrain.main(extra + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path), "--ckpt-every", "1"])
    capsys.readouterr()
    return out


@pytest.mark.parametrize("args,stop", [
    ("--arch none --policy discounted_ucb --rounds 8 --failure-prob 0.2 "
     "--swap-clients 2", 6),
    ("--arch none --policy random --rounds 6", 4),
    ("--arch smollm-135m --rounds 3 --clients 10", 1),
    ("--arch cifar-cnn --fast --rounds 2 --clients 10", 1)])
def test_train_main_resume_equals_straight_run(args, stop, tmp_path, capsys):
    """A run cut after ``stop`` rounds (its later checkpoints deleted; the
    manager keeps the 3 newest) and resumed with ``--resume`` ends where an
    uninterrupted run does."""
    argv = args.split()
    straight = _run(tmp_path / "a", argv, capsys)
    _run(tmp_path / "b", argv, capsys)
    for p in (tmp_path / "b").glob("ckpt_*"):
        if int(p.name.split("_")[1]) > stop:
            shutil.rmtree(p)
    resumed = _run(tmp_path / "b", argv + ["--resume"], capsys)
    assert resumed["start"] == stop
    sa, sb = straight["server"], resumed["server"]
    assert [r.selected for r in sa.history[stop:]] == \
        [r.selected for r in sb.history]
    assert sa.elapsed == sb.elapsed
    for name in ("n_sel", "sum_ud", "hist_ul", "hist_n"):
        np.testing.assert_array_equal(getattr(sa.stats, name),
                                      getattr(sb.stats, name))
    if straight["trainer"] is not None:
        ta, tb = straight["trainer"], resumed["trainer"]
        assert ta.rounds_done == tb.rounds_done
        for a, b in zip(tree_leaves(ta.params), tree_leaves(tb.params)):
            assert torch.equal(a, b)
