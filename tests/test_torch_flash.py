"""The port's attention forward (kernels/ref.flash_attention_ref, the plain
version of the CUDA kernel kernels/csrc/flash_attention.cu, and
models/layers.flash_attention) against the JAX package's three functions
on the same numpy inputs: the Pallas kernel in interpret mode, its naive
reference and the blockwise jnp function of models/layers.py.

Tolerances are the JAX package's own for this kernel
(tests/test_kernels.py): float32 rtol 2e-5 / atol 1e-5 (both sides
accumulate in float32, in other orders); bfloat16 rtol 2e-2 / atol 2e-2
(the output is rounded to bfloat16, one ulp is 2**-8 relative).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, b, sq, skv, kv, g, dh, dtype):
    """(torch q, k, v), (jax q, k, v): the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    shapes = ((b, sq, kv, g, dh), (b, skv, kv, dh), (b, skv, kv, dh))
    ts = [torch.tensor(rng.standard_normal(s), dtype=torch.float32).to(tdt)
          for s in shapes]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_jax(causal, dh, g, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(dh + g, 2, 256, 256, 2, g, dh, dtype)
    # small blocks so the online softmax crosses blocks and skips some
    got = ref.flash_attention_ref(q, k, v, causal, q_block=64, kv_block=128)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jflash.flash_attention_fwd(jq, jk, jv, causal=causal,
                                        block_q=128, block_kv=128,
                                        interpret=True)
    _close(got, pallas, dtype, "Pallas kernel (interpret)")
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal), dtype,
           "naive reference")
    _close(got, jlayers.flash_attention(jq, jk, jv, causal=causal,
                                        q_block=128, kv_block=128),
           dtype, "models.layers.flash_attention")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(200, 200), (150, 333), (333, 150)])
def test_flash_ref_ragged_lengths(sq, skv, causal):
    """Lengths that are no block multiple (the JAX kernel asserts
    divisibility; the port masks the ragged edge) against the naive JAX
    reference, which takes any length; top-left causal mask."""
    (q, k, v), (jq, jk, jv) = _inputs(7, 2, sq, skv, 1, 4, 64, "float32")
    got = ref.flash_attention_ref(q, k, v, causal, q_block=64, kv_block=128)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal), "float32")


@pytest.mark.parametrize("kw", [dict(window=48), dict(q_offset=128),
                                dict(kv_valid_len=200),
                                dict(q_offset=64, kv_valid_len=192,
                                     window=100)],
                         ids=["window", "q_offset", "kv_valid_len", "all"])
def test_layers_flash_attention_masks_match_jax(kw):
    """The port's models/layers.flash_attention (the plain version with its
    extra masks) against the JAX function, causal, float32."""
    (q, k, v), (jq, jk, jv) = _inputs(3, 1, 128, 256, 2, 3, 32, "float32")
    got = tlayers.flash_attention(q, k, v, causal=True, q_block=64,
                                  kv_block=64, **kw)
    want = jlayers.flash_attention(jq, jk, jv, causal=True, q_block=64,
                                   kv_block=64, **kw)
    _close(got, want, "float32", str(kw))


def test_ops_flash_attention_on_cpu_runs_the_plain_version():
    (q, k, v), _ = _inputs(5, 1, 96, 96, 1, 2, 64, "bfloat16")
    before = dict(tflash.launch_counts)
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, True))
    assert tflash.launch_counts == before


def test_kernel_wrapper_refuses_cpu_tensors():
    (q, k, v), _ = _inputs(5, 1, 16, 16, 1, 2, 64, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_cuda(q, k, v)
