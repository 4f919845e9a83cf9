"""The port's Eq. (8) sampling against the JAX package's: the float32
erfinv polynomial against ``jax.scipy.special.erfinv``, the truncated-
normal transform and the candidate-slice times.

Tolerances: erfinv within 2 ulp (XLA contracts the polynomial's
multiply-adds into FMAs and has its own log1p; the port rounds each
operation).  The drawn resources within rtol 1e-6 (that ulp-level erfinv
gap, plus XLA's vs PyTorch's pow and sqrt), with an absolute floor of 1e-6
of the mean: near the lower truncation point mean + sigma * z cancels, so
the rounding error is relative to the mean, not to the result.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.sim import truncnorm as jax_truncnorm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.sim import truncnorm  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulp distance of two float32 arrays of one sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_close_to_scale(got, want, scale):
    """|got - want| <= 1e-6 * (|want| + scale), elementwise."""
    err = np.abs(got.astype(np.float64) - want) - 1e-6 * (np.abs(want)
                                                          + scale)
    assert err.max() <= 0, (f"worst at {err.argmax()}: got "
                            f"{got.flat[err.argmax()]}, want "
                            f"{want.flat[err.argmax()]}")


def test_erfinv_within_2_ulp_of_jax():
    x = np.linspace(-1, 1, 400_001, dtype=np.float32)[1:-1]
    edge = np.nextafter(np.float32(1), np.float32(0)) - np.arange(
        200, dtype=np.float32) * np.float32(2 ** -24)
    x = np.concatenate([x, edge, -edge, [0.0, 0.6826895, -0.6826895]]).astype(
        np.float32)
    got = truncnorm.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    assert _ulps(got, want).max() <= 2


def test_erfinv_endpoints_are_infinite_as_in_jax():
    x = np.array([-1.0, 1.0], np.float32)
    got = truncnorm.erfinv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.scipy.special.erfinv(jnp.asarray(x))))


@pytest.mark.parametrize("eta", [1.0, 1.5, 1.9, 1.99])
def test_truncnorm_transform_matches_jax(eta):
    rng = np.random.default_rng(int(eta * 100))
    u = rng.random(20_000, np.float32)
    mean = np.concatenate([rng.uniform(2e5, 8.6e6, 10_000),
                           rng.uniform(1, 100, 10_000)]).astype(np.float32)
    got = truncnorm.truncnorm_transform(torch.from_numpy(u),
                                        torch.from_numpy(mean), eta).numpy()
    want = np.asarray(jax_truncnorm.truncnorm_transform(
        jnp.asarray(u), jnp.asarray(mean), eta))
    _assert_close_to_scale(got, want, mean)
    sigma = np.sqrt(mean.astype(np.float64) ** eta)
    assert np.all(got >= (mean - sigma) * (1 - 1e-6))
    assert np.all(got <= (mean + sigma) * (1 + 1e-6))


@pytest.mark.parametrize("fluctuate", [True, False])
def test_truncnorm_times_ref_matches_jax(fluctuate):
    rng = np.random.default_rng(3)
    g, c = 3, 500
    etas = np.array([1.0, 1.5, 1.9], np.float32)
    u2 = rng.random((g, 2, c), np.float32)
    mu_t = rng.uniform(2e5, 8.6e6, (g, c)).astype(np.float32)
    mu_g = rng.uniform(10, 100, (g, c)).astype(np.float32)
    n = rng.integers(100, 1001, (g, c)).astype(np.float32)
    bits = np.float32(146.4e6)
    t = torch.from_numpy
    got_ud, got_ul = ref.truncnorm_times_ref(
        t(u2), t(mu_t), t(mu_g), t(n), t(etas), float(bits),
        fluctuate=fluctuate)
    for i in range(g):
        want_ud, want_ul = jax_ref.truncnorm_times_ref(
            jnp.asarray(u2[i]), jnp.asarray(mu_t[i]), jnp.asarray(mu_g[i]),
            jnp.asarray(n[i]), jnp.float32(etas[i]), bits,
            fluctuate=fluctuate)
        # compare the drawn gamma = D / t_UD and theta = M / t_UL
        _assert_close_to_scale(n[i] / got_ud[i].numpy(),
                               n[i] / np.asarray(want_ud), mu_g[i])
        _assert_close_to_scale(bits / got_ul[i].numpy(),
                               bits / np.asarray(want_ul), mu_t[i])


def test_numpy_half_is_the_jax_packages():
    rng = np.random.default_rng(0)
    u, mean = rng.random(1000), rng.uniform(1, 1e6, 1000)
    np.testing.assert_array_equal(
        truncnorm.truncnorm_transform_np(u, mean, 1.7),
        jax_truncnorm.truncnorm_transform_np(u, mean, 1.7))
    assert (truncnorm.P_LO, truncnorm.P_HI) == (jax_truncnorm.P_LO,
                                                jax_truncnorm.P_HI)
