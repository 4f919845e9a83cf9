"""The port's RG-LRU scan (kernels/ref.rg_lru_ref, the plain version of the
CUDA kernel kernels/csrc/rg_lru.cu, and its routing in kernels/ops.py)
against the JAX package's three functions on the same numpy inputs: the
Pallas kernel in interpret mode, its sequential reference
``kernels/ref.rg_lru_ref`` and the in-model ``models/griffin.rg_lru_scan``.

Tolerances.  Against the Pallas kernel and the sequential JAX reference:
bitwise, in float32 and bfloat16.  Both loop over T with a float32 carry,
and each step rounds once: the port through ``torch.addcmul``, XLA by
contracting ``a * h + b`` into a fused multiply-add.  The
outputs agree in every entry; ``a * h + b`` rounded twice would differ in
about a third of them, by up to ~1e-6.  Against the associative scan of
the griffin model, float32 atol 2e-6 / rtol 0: a tree of products and sums
rounds at other places than a sequential loop.  Gaps read up to 4.8e-7 at
|y| <~ 1.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rg_lru as trg  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ASSOC_ATOL = 2e-6


def _inputs(seed, shape, dtype):
    """(torch a, b), (jax a, b): a in (0, 1), b of model scale (|y| <~ 1),
    the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * np.sqrt(1.0 - a * a)).astype(np.float32)
    ts = [torch.tensor(x).to(tdt) for x in (a, b)]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _bits(x):
    x = x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))
    return x.view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 512), (2, 1024, 512),
                                   (3, 512, 1024)])
def test_ref_is_bitwise_the_pallas_kernel(shape, dtype):
    """The shapes of the JAX package's kernel test (T % 256 == 0 and
    W % 512 == 0, which the Pallas kernel asserts)."""
    (a, b), (ja, jb) = _inputs(shape[1] + shape[2], shape, dtype)
    got = ref.rg_lru_ref(a, b)
    assert got.dtype == a.dtype and got.shape == a.shape
    pallas = jops.rg_lru_scan(ja, jb, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(jref.rg_lru_ref(ja, jb)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 100, 77), (1, 1, 5), (2, 257, 513)])
def test_ref_is_bitwise_the_jax_reference_at_ragged_shapes(shape, dtype):
    """Any T and W (the kernel masks the ragged edge) against the JAX
    package's sequential reference, which takes any shape."""
    (a, b), (ja, jb) = _inputs(sum(shape), shape, dtype)
    np.testing.assert_array_equal(_bits(ref.rg_lru_ref(a, b)),
                                  _bits(jref.rg_lru_ref(ja, jb)))


def test_double_rounding_would_be_caught():
    """The check above can tell one rounding from two: ``a * h + b``
    computed in two roundings differs from the reference."""
    (a, b), _ = _inputs(0, (2, 512, 512), "float32")
    h = torch.zeros(2, 512)
    two = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        two[:, t] = h
    assert (ref.rg_lru_ref(a, b) != two).any()


@pytest.mark.parametrize("shape", [(2, 512, 512), (1, 300, 130)])
def test_model_scan_matches_the_associative_scan(shape):
    """The port's griffin.rg_lru_scan (a, b built as the model builds them,
    then the sequential plain version) against the JAX model's
    lax.associative_scan, float32."""
    rng = np.random.default_rng(shape[1])
    x, r, i = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lam = rng.uniform(0.0, 1.0, shape[2]).astype(np.float32)
    got, h = tgriffin.rg_lru_scan(*(torch.tensor(v) for v in (x, r, i, lam)))
    want, jh = jgriffin.rg_lru_scan(*(jnp.asarray(v) for v in (x, r, i, lam)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ASSOC_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=ASSOC_ATOL)
    assert h.untyped_storage().data_ptr() != got.untyped_storage().data_ptr()


def test_ops_rg_lru_scan_on_cpu_runs_the_plain_version(monkeypatch):
    (a, b), _ = _inputs(5, (2, 40, 24), "bfloat16")
    calls = []
    plain = ref.rg_lru_ref
    monkeypatch.setattr(ref, "rg_lru_ref",
                        lambda *x: calls.append(1) or plain(*x))
    before = dict(trg.launch_counts)
    got = ops.rg_lru_scan(a, b)
    assert calls == [1] and trg.launch_counts == before
    assert torch.equal(got, plain(a, b))


def test_kernel_wrapper_refuses_cpu_tensors():
    (a, b), _ = _inputs(5, (1, 8, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        trg.rg_lru_scan_cuda(a, b)


def test_wrapper_argtypes_match_the_c_entry_point():
    """The ctypes signature the wrapper sets has one entry per parameter of
    ``rg_lru_launch`` in the CUDA source (it cannot be loaded here)."""
    src = (trg._build.CSRC / "rg_lru.cu").read_text()
    head = src.split("int rg_lru_launch(", 1)[1].split(")", 1)[0]
    assert len(head.split(",")) == len(trg._ARGTYPES)
    assert "__fmaf_rn(" in src
