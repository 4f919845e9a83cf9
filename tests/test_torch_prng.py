"""The port's Threefry streams (``core/prng.py``, the plain version of the
``threefry`` kernel in ``kernels/ref.py``) against ``jax.random``, on the
CPU.

  1. ``prng_key`` (32-bit seeds, negative ones wrapping; 64-bit seeds split
     into their words), ``split`` (also at an offset into a larger split),
     ``fold_in`` (a constant and per-row data on the device),
     ``random_bits`` over 1-, 2- and 3-D shapes and at a counter offset,
     ``uniform`` with and without bounds, ``randint`` (spans below and
     above 2^16), ``permutation`` at n = 100 and 1625 (one sorting round),
     1626 and 5000 (two), and ``lax.sort_key_val``'s order on forced ties:
     bitwise;
  2. ``normal`` within 3 ulp: its uniforms are bitwise, and the port's
     float32 ``erfinv`` is within 2 ulp of XLA's FMA-contracted one, which
     the multiply by sqrt(2) can round to 3;
  3. the draws the sweep makes from a round's keys, against the JAX
     package's functions: ``bandit.fault_uniforms``,
     ``bandit.hier_cell_uniforms`` (``fold_in`` of cell ids),
     ``engine.churn_draws`` (``engine_jax.churn_step``'s four subkeys) and
     ``sim.truncnorm.sample_truncated_normal_key`` (rtol 1e-6: its
     transform's erfinv);
  4. the kernel's wrapper refuses CPU tensors and the plain version's
     contract (shapes, dtypes, outputs).

Tolerances: none but (2)'s and (3)'s truncated normal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandit_jax  # noqa: E402
from repro.sim import truncnorm as jtruncnorm  # noqa: E402
from repro_torch.core import bandit, prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.threefry import threefry_cuda  # noqa: E402
from repro_torch.sim import engine, truncnorm  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

SEEDS = (0, 1, 7, 42, -1, -5, 2 ** 31 - 1, 123456789)
N_KEYS = 64


def _words(x) -> np.ndarray:
    """A uint32 (or float32) jax array as int32 words."""
    return np.asarray(x).view(np.int32)


@pytest.fixture(scope="module")
def keys():
    """(jax [N, 2] keys, the port's same keys)."""
    jk = jax.random.split(jax.random.PRNGKey(2024), N_KEYS)
    tk = prng.split(prng.prng_key(2024), N_KEYS)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    return jk, tk


def _vmap(fn, jk):
    return jax.jit(jax.vmap(fn))(jk)


def test_prng_key_matches_jax():
    got = prng.prng_key(SEEDS).numpy()
    want = np.stack([_words(jax.random.PRNGKey(s)) for s in SEEDS])
    np.testing.assert_array_equal(got, want)
    # int32 tensors are 32-bit seeds; the sweep's vmapped PRNGKey of its
    # int32 seed vector gives the same
    t32 = prng.prng_key(torch.tensor(SEEDS, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(t32, want)
    np.testing.assert_array_equal(
        _words(jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS, jnp.int32))),
        want)
    # a 64-bit seed: its high and low words (threefry_seed's contract)
    s64 = torch.tensor([-1, 2 ** 40 + 3, 5], dtype=torch.int64)
    np.testing.assert_array_equal(
        prng.prng_key(s64).numpy().view(np.uint32),
        [[0xFFFFFFFF, 0xFFFFFFFF], [2 ** 8, 3], [0, 5]])


@pytest.mark.parametrize("num,offset", [(2, 0), (6, 0), (500, 0), (37, 100)])
def test_split_matches_jax(keys, num, offset):
    jk, tk = keys
    want = _vmap(lambda k: jax.random.split(k, offset + num)[offset:], jk)
    np.testing.assert_array_equal(prng.split(tk, num, offset=offset).numpy(),
                                  _words(want))


def test_fold_in_matches_jax(keys):
    jk, tk = keys
    want = _vmap(lambda k: jax.random.fold_in(k, 0xFA11), jk)
    np.testing.assert_array_equal(prng.fold_in(tk, 0xFA11).numpy(),
                                  _words(want))
    data = np.random.default_rng(0).integers(0, 2 ** 31, (N_KEYS, 3))
    got = prng.fold_in(tk[:, None], torch.from_numpy(data))
    want = jax.vmap(jax.vmap(jax.random.fold_in, (None, 0)))(
        jk, jnp.asarray(data, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("shape", [(1,), (7,), (100,), (3, 5), (2, 3, 4),
                                   ()])
def test_bits_and_uniform_match_jax(keys, shape):
    jk, tk = keys
    bits = _vmap(lambda k: jax.random.bits(k, shape, jnp.uint32), jk)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  _words(bits))
    u = _vmap(lambda k: jax.random.uniform(k, shape), jk)
    np.testing.assert_array_equal(_words(prng.uniform(tk, shape).numpy()),
                                  _words(u))


def test_bits_at_an_offset_are_that_slice(keys):
    jk, tk = keys
    whole = _vmap(lambda k: jax.random.bits(k, (1000,), jnp.uint32), jk)
    np.testing.assert_array_equal(
        prng.random_bits(tk, (150,), offset=300).numpy(),
        _words(whole)[:, 300:450])
    u = _vmap(lambda k: jax.random.uniform(k, (4, 250)), jk)
    np.testing.assert_array_equal(
        _words(prng.uniform(tk, 250, offset=500).numpy()),
        _words(u).reshape(N_KEYS, -1)[:, 500:750])


@pytest.mark.parametrize("lo,hi", [(10.0, 100.0), (-3.5, 7.25), (1.0, 10.0),
                                   (0.1, 0.3), (-0.99999994, 1.0)])
def test_bounded_uniform_matches_jax(keys, lo, hi):
    """XLA:CPU contracts ``floats * (hi - lo) + lo`` into one FMA; the
    port rounds it once too, bitwise."""
    jk, tk = keys
    want = _vmap(lambda k: jax.random.uniform(k, (50,), jnp.float32, lo, hi),
                 jk)
    got = prng.uniform(tk, (50,), lo, hi)
    np.testing.assert_array_equal(_words(got.numpy()), _words(want))
    assert float(got.min()) >= np.float32(lo)


@pytest.mark.parametrize("span", [1, 16, 100, 65536, 70000, 10 ** 6])
def test_randint_matches_jax(keys, span):
    jk, tk = keys
    want = _vmap(lambda k: jax.random.randint(k, (3, 4), 5, 5 + span), jk)
    np.testing.assert_array_equal(prng.randint(tk, (3, 4), 5, 5 + span),
                                  np.asarray(want))
    want = _vmap(lambda k: jax.random.randint(k, (), 0, span), jk)
    np.testing.assert_array_equal(prng.randint(tk, (), 0, span),
                                  np.asarray(want))


@pytest.mark.parametrize("n", [100, 1625, 1626, 5000])
def test_permutation_matches_jax(keys, n):
    jk, tk = keys
    assert prng.shuffle_rounds(n) == (1 if n < 1626 else 2)
    want = _vmap(lambda k: jax.random.permutation(k, n), jk[:8])
    np.testing.assert_array_equal(prng.permutation(tk[:8], n).numpy(),
                                  np.asarray(want))


def test_sort_key_val_keeps_tied_keys_in_order():
    """A 32-bit collision among K = 100 sort keys has a chance of about
    1e-6 a draw; forced here, with keys on both sides of 2^31, against
    ``lax.sort_key_val``."""
    rng = np.random.default_rng(3)
    sk = rng.choice(np.array([5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 7],
                             np.uint32), (4, 100))
    x = np.stack([rng.permutation(100) for _ in range(4)])
    want = jax.vmap(lambda a, b: jax.lax.sort_key_val(a, b)[1])(
        jnp.asarray(sk), jnp.asarray(x, jnp.int32))
    got = prng.sort_key_val(torch.from_numpy(sk.view(np.int32)),
                            torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ordered(x: np.ndarray) -> np.ndarray:
    """float32 -> int64 in the floats' order, so differences count ulp
    (+0 and -0 equal)."""
    b = x.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def test_normal_within_3_ulp(keys):
    jk, tk = keys
    want = np.asarray(_vmap(lambda k: jax.random.normal(k, (200,)), jk))
    got = prng.normal(tk, (200,)).numpy()
    ulp = np.abs(_ordered(got) - _ordered(want))
    assert ulp.max() <= 3, ulp.max()
    assert (ulp == 0).mean() > 0.9


def test_sweep_draws_from_round_keys_match_jax(keys):
    jk, tk = keys
    np.testing.assert_array_equal(
        _words(bandit.fault_uniforms(tk, 5).numpy()),
        _words(_vmap(lambda k: bandit_jax.fault_uniforms(k, 5), jk)))
    # the hierarchical round's per-cell draws, cell ids on the device
    cells = torch.tensor(np.random.default_rng(1).integers(0, 100,
                                                           (N_KEYS, 4)))
    got = bandit.hier_cell_uniforms(tk, cells, 13)
    want = jax.vmap(jax.vmap(
        lambda k, c: jax.random.uniform(jax.random.fold_in(k, c), (13,)),
        (None, 0)))(jk, jnp.asarray(cells.numpy(), jnp.int32))
    np.testing.assert_array_equal(_words(got.numpy()), _words(want))
    # churn: whether, the randint victim as (j + 0.5) / K, the uniforms
    k = 1000

    def churn(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        j = jax.random.randint(k2, (), 0, k)
        return (jax.random.uniform(k1), j, jax.random.uniform(k3),
                jax.random.uniform(k4, (), jnp.float32, 10.0, 100.0))
    u1, j, u3, gamma = (np.asarray(a) for a in _vmap(churn, jk))
    d = engine.churn_draws(tk, k)
    np.testing.assert_array_equal(_words(d[:, 0].numpy()), _words(u1))
    np.testing.assert_array_equal(_words(d[:, 2].numpy()), _words(u3))
    np.testing.assert_array_equal((d[:, 1] * k).long().numpy(), j)
    # churn_step turns the last uniform into jax's bounded capability
    ones = torch.ones(N_KEYS, k)
    d[:, 0] = 0.0                                # every row churns
    _, g = engine.churn_step(d, ones, ones.clone(), 0.2)
    victim = torch.as_tensor(j.copy()).long()
    np.testing.assert_array_equal(
        _words(g[torch.arange(N_KEYS), victim].numpy()), _words(gamma))


def test_truncated_normal_from_a_key_matches_jax(keys):
    """``sim.truncnorm.sample_truncated_normal_key`` against the JAX
    package's ``sample_truncated_normal_jax`` on the same keys: the
    uniforms bitwise, the transform's float32 erfinv within 2 ulp, so the
    samples within rtol 1e-6."""
    jk, tk = keys
    mean = np.random.default_rng(5).uniform(1e5, 1e7, (N_KEYS, 30)).astype(
        np.float32)
    want = jax.vmap(lambda k, m: jtruncnorm.sample_truncated_normal_jax(
        k, m, 1.7))(jk, jnp.asarray(mean))
    got = truncnorm.sample_truncated_normal_key(tk, torch.from_numpy(mean),
                                                1.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    one = truncnorm.sample_truncated_normal_key(tk[3], torch.from_numpy(
        mean[3]), 1.7)                          # one key, a [30] mean
    assert one.shape == (30,)
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[3], rtol=1e-6,
                               atol=0)


def test_kernel_wrapper_and_plain_contract():
    key = prng.prng_key([3, 4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        threefry_cuda(key, 5)
    with pytest.raises(ValueError, match="out must be"):
        ops.threefry(key, 5, out="floats")
    with pytest.raises(ValueError, match="int32"):
        prng.uniform(key.long(), 3)
    bits = ref.threefry_ref(key, 5)
    pairs = ref.threefry_ref(key, 5, out="pairs")
    u = ref.threefry_ref(key, 5, out="uniform", minval=2.0, maxval=3.0)
    assert bits.shape == (2, 5) and bits.dtype == torch.int32
    assert pairs.shape == (2, 5, 2) and pairs.dtype == torch.int32
    assert u.dtype == torch.float32 and bool(((u >= 2) & (u < 3)).all())
    torch.testing.assert_close(bits, pairs[..., 0] ^ pairs[..., 1],
                               rtol=0, atol=0)
    # per-row offsets are fold_in's data
    rows = ref.threefry_ref(key, 1, row_offsets=torch.tensor([9, 11]),
                            out="pairs")[:, 0]
    torch.testing.assert_close(rows, torch.stack(
        [prng.fold_in(key[0], 9), prng.fold_in(key[1], 11)]), rtol=0,
        atol=0)
