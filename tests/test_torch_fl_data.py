"""The port's numpy copies of the FL data path — synthetic CIFAR,
partitions, the accuracy-vs-time metrics, the lr schedule — and its
``make_cnn_task`` against the JAX package's, on the CPU.  Everything here
is exact: the same seeds must give byte-identical arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import metrics as jmetrics  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.fl import engine, metrics  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)


@pytest.mark.parametrize("seed,size", [(0, 8), (3, 32)])
def test_synthetic_cifar_is_byte_identical(seed, size):
    got = synthetic.make_synthetic_cifar(300, 100, size=size, seed=seed)
    want = jsyn.make_synthetic_cifar(300, 100, size=size, seed=seed)
    for g, w in zip(got, want):
        assert g.x.dtype == w.x.dtype and g.y.dtype == w.y.dtype
        assert g.x.tobytes() == w.x.tobytes()
        assert g.y.tobytes() == w.y.tobytes()


def test_partitions_are_byte_identical():
    train, _ = synthetic.make_synthetic_cifar(500, 10, size=8, seed=1)
    sizes = np.random.default_rng(2).integers(5, 120, 9).astype(np.float64)
    for split in ("iid", "dirichlet"):
        if split == "iid":
            got = partition.iid_partition(train, sizes,
                                          np.random.default_rng(7))
            want = jpart.iid_partition(train, sizes, np.random.default_rng(7))
        else:
            got = partition.dirichlet_partition(
                train, sizes, 0.3, np.random.default_rng(7))
            want = jpart.dirichlet_partition(train, sizes, 0.3,
                                             np.random.default_rng(7))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for kw in ({}, {"round_to": 10}, {"cap": 30}):
            for g, w in zip(partition.pad_partitions(got, **kw),
                            jpart.pad_partitions(want, **kw)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    elapsed = np.cumsum(rng.uniform(10, 100, (3, 2, 12)), axis=-1)
    acc = np.clip(np.cumsum(rng.uniform(0, 0.1, (3, 2, 12)), -1), 0, 1)
    for t in (0.2, 0.5, 2.0):
        np.testing.assert_array_equal(metrics.time_to_accuracy(elapsed, acc, t),
                                      jmetrics.time_to_accuracy(elapsed, acc,
                                                                t))
    grid = np.linspace(0, elapsed.max() * 1.1, 17)
    np.testing.assert_array_equal(metrics.accuracy_at_time(elapsed, acc, grid),
                                  jmetrics.accuracy_at_time(elapsed, acc,
                                                            grid))
    np.testing.assert_array_equal(metrics.final_accuracy(acc, 3),
                                  jmetrics.final_accuracy(acc, 3))
    names = ["fedcs", "elementwise_ucb", "random"]
    assert (metrics.toa_table(names, elapsed, acc, (0.3, 0.6))
            == jmetrics.toa_table(names, elapsed, acc, (0.3, 0.6)))


def test_lr_schedule_matches_jax():
    assert sgd.PAPER_LR0 == jsgd.PAPER_LR0
    assert sgd.PAPER_LR_DECAY == jsgd.PAPER_LR_DECAY
    got = sgd.round_lrs(300)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jengine._round_lrs(300)))
    assert sgd.paper_lr(7) == jsgd.paper_lr(7)


def test_make_cnn_task_matches_jax():
    kw = dict(image_size=8, channels=(8, 8), pool_after=(0,), fc_units=(16,))
    args = dict(n_clients=12, n_train=600, n_test=450, eval_batch=200,
                max_samples=40, batch_size=10, seed=4)
    jt = jengine.make_cnn_task("correlated-congestion",
                               cfg=jcnn.CnnConfig(**kw), **args)
    tt = engine.make_cnn_task("correlated-congestion",
                              cfg=cnn.CnnConfig(**kw), device="cpu", **args)
    np.testing.assert_array_equal(tt.train_x.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jt.train_x))
    np.testing.assert_array_equal(tt.test_x.permute(0, 1, 3, 4, 2).numpy(),
                                  np.asarray(jt.test_x))
    for name in ("train_y", "test_y", "test_mask", "part_idx", "part_count"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    for name in ("mean_theta", "mean_gamma", "n_samples", "cell_id"):
        np.testing.assert_array_equal(getattr(tt.env, name).numpy(),
                                      np.asarray(getattr(jt.env, name)),
                                      err_msg=name)
    assert tt.n_clients == 12 and tt.test_x.shape[:2] == (3, 200)
    assert not tt.test_mask[-1, 50:].any()
