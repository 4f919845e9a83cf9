"""The port's upload compression (repro_torch.distributed.compression)
against the JAX package's ``repro.distributed.compression`` on the same
numpy float32 inputs, on the CPU.

Tolerance: none.  The int8 codes, scales and round trips and the top-k
values, indices and round trips (error feedback included) are bitwise the
JAX package's: the same absmax + 1e-12, one rounding of absmax / 127,
round half to even, and the lower index first among equal magnitudes —
the inputs include ties, k = 1 and k = n.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jc  # noqa: E402
from repro_torch.distributed import compression as tc  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)


def _inputs():
    rng = np.random.default_rng(0)
    ties = np.repeat(np.array([3.0, -3.0, 1.0, -1.0, 0.5], np.float32), 7)
    half = (np.arange(-40, 41, dtype=np.float32) * 0.5)   # .5 code steps
    return {
        "normal": rng.standard_normal(1000).astype(np.float32),
        "tiny": (rng.standard_normal((13, 7)) * 1e-6).astype(np.float32),
        "huge": (rng.standard_normal(257) * 1e6).astype(np.float32),
        "ties": rng.permutation(ties).astype(np.float32),
        "half_steps": half * np.float32(127.0 / 20.0),
        "zeros": np.zeros(16, np.float32),
        "one": np.array([-2.5], np.float32),
    }


INPUTS = _inputs()


def _eq(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_int8_bitwise_jax(name):
    x = INPUTS[name]
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape == x.shape
    assert _eq(tq, jq) and np.float32(ts) == np.float32(js)
    assert _eq(tc.dequantize_int8(tq, ts), jc.dequantize_int8(jq, js))
    assert _eq(tc.int8_roundtrip(torch.from_numpy(x)),
               jc.int8_roundtrip(jnp.asarray(x)))


@pytest.mark.parametrize("ratio", [1e-9, 0.01, 0.1, 0.37, 1.0])
@pytest.mark.parametrize("name", ["normal", "ties", "tiny", "one",
                                  "half_steps"])
def test_topk_bitwise_jax(name, ratio):
    x = INPUTS[name]
    jv, ji, jk = jc.topk_compress(jnp.asarray(x), ratio)
    tv, ti, tk = tc.topk_compress(torch.from_numpy(x), ratio)
    assert tk == jk == max(1, int(x.size * ratio))
    assert ti.dtype == torch.int32
    assert _eq(ti, ji) and _eq(tv, jv)
    ja, je = jc.topk_roundtrip(jnp.asarray(x), ratio)
    ta, te = tc.topk_roundtrip(torch.from_numpy(x), ratio)
    assert _eq(ta, ja) and _eq(te, je)
    assert _eq(tc.topk_decompress(tv, ti, x.size, x.shape),
               jc.topk_decompress(jv, ji, x.size, x.shape))


def test_topk_ties_go_to_the_lower_index():
    x = torch.tensor([1.0, -2.0, 2.0, -2.0, 0.5])
    vals, idx, k = tc.topk_compress(x, 0.4)
    assert k == 2 and idx.tolist() == [1, 2] and vals.tolist() == [-2.0, 2.0]
    assert tc.topk_compress(x, 0.0)[1].tolist() == [1]       # k = 1


def test_tree_roundtrips_with_error_feedback_bitwise_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(40).astype(np.float32)}}
    jtree = {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(
        tree["b"]["c"])}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    j8, t8 = jc.tree_int8_roundtrip(jtree), tc.tree_int8_roundtrip(ttree)
    assert _eq(t8["a"], j8["a"]) and _eq(t8["b"]["c"], j8["b"]["c"])
    jerr = terr = None
    for _ in range(4):
        japprox, jerr = jc.tree_topk_roundtrip(jtree, 0.1, jerr)
        tapprox, terr = tc.tree_topk_roundtrip(ttree, 0.1, terr)
        for path in (("a",), ("b", "c")):
            ja, ta, je, te = japprox, tapprox, jerr, terr
            for key in path:
                ja, ta, je, te = ja[key], ta[key], je[key], te[key]
            assert _eq(ta, ja) and _eq(te, je)


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_compression_bytes_match_jax(method):
    tree = {"w": np.zeros((64, 33), np.float32), "b": np.zeros(7, np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert tc.compression_bytes(tt, method, 0.05) == jc.compression_bytes(
        jt, method, 0.05)
    with pytest.raises(ValueError):
        tc.compression_bytes(tt, "zip")
