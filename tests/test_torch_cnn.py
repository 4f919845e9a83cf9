"""The port's CNN (repro_torch.models.cnn) and its weight converter against
the JAX package's ``models.cnn``, on the CPU.

Both packages get the same numpy images and the JAX package's initial
weights, carried across by ``repro_torch.convert``.  Tolerances, relative
to the largest entry: logits and each leaf's gradient within 1e-5 at the
small sizes (PyTorch's and XLA's convolutions and batch statistics sum in
different orders), the loss within rtol 1e-5; the full-width forward within
1e-4 (six BatchNorm layers over 2 images amplify those differences).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import SMALL_CNN, TWO_POOL_CNN, cnn_configs  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

CASES = {"small-bn": (SMALL_CNN, True), "small": (SMALL_CNN, False),
         "two-pool-bn": (TWO_POOL_CNN, True)}


_init = jax.jit(jcnn.init, static_argnames="cfg")
_apply = jax.jit(jcnn.apply, static_argnames="cfg")


@functools.partial(jax.jit, static_argnames="cfg")
def _value_and_grad(params, batch, cfg):
    return jax.value_and_grad(lambda p: jcnn.loss_fn(p, batch, cfg)[0])(params)


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, _init(jax.random.PRNGKey(seed), jcfg))


def _batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((b, cfg.image_size, cfg.image_size, 3), np.float32)
    return x, rng.integers(0, cfg.n_classes, b).astype(np.int32)


def _rel_max(got, want):
    """Largest difference relative to the largest |want| (0 when both are
    all zero, as BatchNorm's gradients are with BatchNorm off)."""
    scale = np.abs(want).max()
    diff = np.abs(got - want).max()
    return float(diff / scale) if scale > 0 else float(diff)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    kw, bn = CASES[case]
    jcfg, cfg = cnn_configs(kw, bn)
    jp = _jax_params(jcfg)
    params = convert.cnn_params_from_jax(jp)
    x, y = _batch(cfg, 6)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    want = np.asarray(_apply(jp, batch["x"], jcfg))
    got = cnn.apply(params, torch.from_numpy(x), cfg).numpy()
    assert _rel_max(got, want) < 1e-5

    jloss, jgrads = _value_and_grad(jp, batch, jcfg)
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    loss = cnn.loss_fn(params, x_nchw, torch.from_numpy(y), cfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = torch.func.grad(cnn.loss_fn)(params, x_nchw, torch.from_numpy(y),
                                         cfg)
    want_g = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert grads.keys() == want_g.keys()
    for name, g in grads.items():
        assert _rel_max(g.numpy(), want_g[name].numpy()) < 1e-5, name


def test_fc0_flatten_order_is_observable():
    """At the two-pool config a (c, h, w) flatten before fc0 — or fc0's rows
    left in the wrong order by the converter — moves the logits far beyond
    the forward test's tolerance, so that test catches either mistake."""
    jcfg, cfg = cnn_configs(TWO_POOL_CNN, True)
    jp = _jax_params(jcfg)
    x, _ = _batch(cfg, 6)
    want = np.asarray(_apply(jp, jnp.asarray(x), jcfg))
    params = convert.cnn_params_from_jax(jp)
    # fc0's 32 inputs are a 2x2x8 map in (h, w, c) order; reorder the rows
    # as a port that flattened NCHW would need them
    w = params["fc0/w"]
    perm = torch.arange(32).view(2, 2, 8).permute(2, 0, 1).reshape(-1)
    params["fc0/w"] = w[:, perm]
    got = cnn.apply(params, torch.from_numpy(x), cfg).numpy()
    assert _rel_max(got, want) > 1e-2


def test_full_width_forward_matches_jax():
    jcfg, cfg = jcnn.CnnConfig(), cnn.CnnConfig()
    jp = _jax_params(jcfg)
    params = convert.cnn_params_from_jax(jp)
    x, _ = _batch(cfg, 2)
    want = np.asarray(_apply(jp, jnp.asarray(x), jcfg))
    got = cnn.apply(params, torch.from_numpy(x), cfg).numpy()
    assert got.shape == (2, 10)
    assert _rel_max(got, want) < 1e-4
    assert cnn.param_count(params) == 4_583_146


def test_port_init_shapes_and_he_std():
    cfg = cnn.CnnConfig()
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    assert cnn.param_count(params) == 4_583_146
    jshapes = jax.eval_shape(lambda: jcnn.init(jax.random.PRNGKey(0),
                                               jcnn.CnnConfig()))
    want = convert.cnn_params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshapes))
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        n: tuple(p.shape) for n, p in want.items()}
    for name, p in params.items():
        leaf = name.split("/")[1]
        if leaf == "w":
            fan_in = int(np.prod(p.shape[1:]))
            std = float(p.std())
            assert abs(std / np.sqrt(2.0 / fan_in) - 1.0) < 0.05, name
        elif leaf == "bn_scale":
            assert torch.equal(p, torch.ones_like(p))
        else:
            assert torch.equal(p, torch.zeros_like(p))


def test_converter_round_trip_is_exact():
    jcfg, _ = cnn_configs(TWO_POOL_CNN, True)
    jp = _jax_params(jcfg, seed=3)
    back = convert.cnn_params_to_jax(convert.cnn_params_from_jax(jp))
    assert back.keys() == jp.keys()
    for layer in jp:
        assert back[layer].keys() == jp[layer].keys()
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf], jp[layer][leaf])
    params = cnn.init(torch.Generator().manual_seed(1),
                      cnn.CnnConfig(**TWO_POOL_CNN))
    again = convert.cnn_params_from_jax(convert.cnn_params_to_jax(params))
    for name in params:
        assert torch.equal(again[name], params[name])
