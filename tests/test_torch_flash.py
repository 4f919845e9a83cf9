"""The port's attention forward (kernels/ref.flash_attention_ref, the plain
version of the CUDA kernel kernels/csrc/flash_attention.cu, and
models/layers.flash_attention) against the JAX package's three functions
on the same numpy inputs: the Pallas kernel in interpret mode, its naive
reference and the blockwise jnp function of models/layers.py.

Tolerances are the JAX package's own for this kernel
(tests/test_kernels.py): float32 rtol 2e-5 / atol 1e-5 (both sides
accumulate in float32, in other orders); bfloat16 rtol 2e-2 / atol 2e-2
(the output is rounded to bfloat16, one ulp is 2**-8 relative).

The bfloat16 tensor-core kernel (kernels/csrc/flash_attention_sm90.cu)
runs only on the card; its arithmetic is emulated here in plain torch and
held against the plain version under chip_smoke.py's bfloat16 gate (rtol
1e-2 / atol 1e-4).
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
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

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


LOG2E = 1.4426950408889634
# chip_smoke.py's bfloat16 gate of the kernel against its plain version
FLASH_TOL_BF16 = dict(rtol=1e-2, atol=1e-4)


def _emulate_wgmma_kernel(q, k, v, causal, bn, split_p=True):
    """The arithmetic of kernels/csrc/flash_attention_sm90.cu in plain torch:
    float32 logits of the bfloat16 values (their products are exact in
    float32), ``exp2`` with dh**-0.5 * log2(e) folded into one multiply,
    P.V with P as hi = bf16(p) plus lo = bf16(p - hi) (or, with
    ``split_p=False``, one bf16 rounding of p), l summed from the float32
    p, over key tiles of ``bn``; the output acc / max(l, 1e-30) rounded
    once to bfloat16."""
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    c = torch.tensor(dh ** -0.5, dtype=torch.float32) * LOG2E
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(b, kv, sq * g, dh)
    kf = k.float().permute(0, 2, 1, 3)                      # [B, KV, Skv, dh]
    vf = v.float().permute(0, 2, 1, 3)
    pos = torch.arange(sq * g) // g
    m = torch.full((b, kv, sq * g), ref.NEG_LOGIT)
    l = torch.zeros(b, kv, sq * g)
    acc = torch.zeros(b, kv, sq * g, dh)
    for k0 in range(0, skv, bn):
        keys = torch.arange(k0, min(k0 + bn, skv))
        x = (qf @ kf[:, :, keys].transpose(-1, -2)) * c
        if causal:
            x = torch.where(keys[None, :] <= pos[:, None], x, ref.NEG_LOGIT)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split_p else torch.zeros_like(p)
        acc = acc * corr[..., None] + hi @ vf[:, :, keys] + lo @ vf[:, :, keys]
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, kv, sq, g, dh)
    return o.permute(0, 2, 1, 3, 4).bfloat16()


@pytest.mark.parametrize("b,s,kv,g,dh,causal", [
    (1, 1024, 1, 3, 64, True), (1, 1024, 1, 3, 64, False),
    (1, 300, 2, 2, 32, False), (2, 333, 1, 3, 128, True)],
    ids=["dh64-causal", "dh64-full", "dh32-ragged-full", "dh128-ragged"])
def test_wgmma_kernel_arithmetic_within_the_bf16_gate(b, s, kv, g, dh,
                                                      causal):
    """The bf16 tensor-core kernel's arithmetic (emulated above: bf16
    logits' products, exp2 with the folded scale, P split into hi + lo)
    holds chip_smoke.py's bfloat16 gate against the plain version, at the
    kernel's key tile (128 keys, 64 at dh 128)."""
    (q, k, v), _ = _inputs(s + dh, b, s, s, kv, g, dh, "bfloat16")
    bn = 64 if dh == 128 else 128
    got = _emulate_wgmma_kernel(q, k, v, causal, bn)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(got, want, **FLASH_TOL_BF16)


def test_one_bf16_rounding_of_p_breaks_the_bf16_gate():
    """Why the kernel splits P: with p rounded to one bfloat16 before P.V,
    outputs near 0 leave the gate (they are protected by atol 1e-4 only)."""
    (q, k, v), _ = _inputs(1088, 1, 1024, 1024, 1, 3, 64, "bfloat16")
    got = _emulate_wgmma_kernel(q, k, v, True, 128, split_p=False)
    want = ref.flash_attention_ref(q, k, v, True)
    bad = ~torch.isclose(got.float(), want.float(), **FLASH_TOL_BF16)
    assert int(bad.sum()) > 1000


# ---------------------------------------------------------------------------
# a query offset: context-parallel slices of the q rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [2, 4])
def test_q_offset_slices_match_jax_and_the_unsplit_call(n_split, dtype):
    """Rank p of P model ranks attends with q rows [p·S/P, (p+1)·S/P) and
    all of k and v at ``q_offset`` p·S/P (models/layers.py's
    context-parallel route): each slice of the plain version equals JAX's
    ``layers.flash_attention(q_offset=)`` on the same slice, and the
    slices concatenated are bitwise the unsplit call (a fully masked key
    block adds exact zeros, so each row sees the same arithmetic)."""
    s = 256
    rs = s // n_split
    (q, k, v), (jq, jk, jv) = _inputs(11, 2, s, s, 2, 3, 32, dtype)
    whole = ref.flash_attention_ref(q, k, v, True, q_block=32, kv_block=64)
    parts = []
    for p in range(n_split):
        sl = slice(p * rs, (p + 1) * rs)
        got = ref.flash_attention_ref(q[:, sl], k, v, True, q_offset=p * rs,
                                      q_block=32, kv_block=64)
        want = jlayers.flash_attention(jq[:, sl], jk, jv, causal=True,
                                       q_offset=p * rs, q_block=32,
                                       kv_block=64)
        _close(got, want, dtype, f"slice {p} of {n_split}")
        parts.append(got)
    assert torch.equal(torch.cat(parts, 1), whole)


def test_ops_flash_attention_takes_q_offset_with_a_gradient():
    """``ops.flash_attention(..., q_offset=)`` on the CPU is the plain
    version at that offset, and its autograd Function differentiates the
    plain version at the same offset."""
    (q, k, v), _ = _inputs(13, 1, 64, 192, 1, 2, 32, "float32")
    got = ops.flash_attention(q, k, v, True, q_offset=128)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, True,
                                                    q_offset=128))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        ops.flash_attention(*xs, True, q_offset=128).square().sum().backward()
        ref.flash_attention_ref(*ys, True, q_offset=128).square().sum(
        ).backward()
    for a, b in zip(xs, ys):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
