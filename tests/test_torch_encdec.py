"""The port's encdec family (models/encdec.py, configs/seamless_m4t_medium.py,
cross-attention in models/layers.attention_apply) against the JAX package
on the CPU, from the JAX package's own random parameters
(``convert.lm_params_from_tree``) and the same numpy-made frames and
tokens.  The reduced config has 2 encoder and 2 decoder layers, d_model
128, 4 heads of 32.

Routes: at 1024 or more tokens (or encoder frames, for cross-attention)
the port sends the encoder's full self-attention, the decoder's causal
self-attention at prefill and every cross-attention with more than one
query through ``ops.flash_attention`` (counted here); the JAX package runs
its blockwise jnp function there, or einsum + softmax where its route
also asks for block-divisible lengths (S = 1100).

Tolerances, float32 compute: rtol 1e-5 / atol 1e-5 on logits and the loss
(both sides sum in float32 in other orders; gaps read up to 4.6e-6 on
logits of magnitude ~3.5), atol 5e-5 on the self-attention cache and the
encoder output; gradients within a relative L2 of 1e-5 per leaf (read up
to 1.6e-6).  bfloat16 compute: logits rtol 2e-2 / atol 8e-2 (activations
rounded to bfloat16 at every matmul, in other places, through 2 encoder
and 2 decoder layers of up to three sublayers each; beyond the rtol part
the gaps read up to 0.061), atol 0.1 on the cache and the encoder output
(read up to 0.074), the loss rtol 2e-2.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import seamless_m4t_medium as jcfgs  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import seamless_m4t_medium as tcfgs  # noqa: E402
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=8e-2)}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=5e-5),
             "bfloat16": dict(rtol=2e-2, atol=0.1)}
GRAD_RL2 = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(dtype, **changes):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jcfgs.REDUCED, compute_dtype=jdt, **changes),
            dataclasses.replace(tcfgs.REDUCED, compute_dtype=tdt, **changes))


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jp = je.init(jax.random.PRNGKey(seed), jcfgs.REDUCED)
    return jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _batch(rng, s_enc, s_dec, d, b=2, vocab=512):
    frames = jnp.asarray(rng.standard_normal((b, s_enc, d)), jnp.bfloat16)
    toks = rng.integers(0, vocab, (b, s_dec)).astype(np.int32)
    return ({"frames": frames, "tokens": toks},
            {"frames": torch.tensor(_np(frames)).to(torch.bfloat16),
             "tokens": torch.tensor(toks)})


def _jax_forward(params, batch, cfg):
    """The decoder's logits of the JAX package's ``loss_fn``."""
    enc_out = je.encode(params, batch["frames"], cfg)
    x = params["embed"]["tok"].astype(cfg.compute_dtype)[batch["tokens"]]
    positions = jnp.arange(x.shape[1])
    for i in range(cfg.n_layers):
        pl = jax.tree.map(lambda a: a[i], params["dec_layers"])
        x, _ = je._dec_block(pl, x, enc_out, cfg, positions)
    x = jl.rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return x @ params["unembed"].astype(cfg.compute_dtype)


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, max_len):
    return (jax.jit(functools.partial(_jax_forward, cfg=jcfg)),
            jax.jit(functools.partial(je.loss_fn, cfg=jcfg)),
            jax.jit(functools.partial(je.prefill, cfg=jcfg, max_len=max_len)),
            jax.jit(functools.partial(je.decode_step, cfg=jcfg)))


def _count_flash(monkeypatch):
    routed = []
    flash = tl.ops.flash_attention
    monkeypatch.setattr(tl.ops, "flash_attention",
                        lambda *a: routed.append(a[3] if len(a) > 3 else True)
                        or flash(*a))
    return routed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_enc,s_dec", [(64, 64), (96, 40), (1024, 1024),
                                         (1024, 64)])
def test_encdec_matches_jax(s_enc, s_dec, dtype, monkeypatch):
    """forward, loss, prefill logits, cache and encoder output, three
    decode steps (each recomputing cross K/V from the encoder output).
    (1024, 64): 64 queries against 1024 frames still take the blockwise
    route for cross-attention, in both packages."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params()
    rng = np.random.default_rng(s_enc + s_dec)
    bj, bt = _batch(rng, s_enc, s_dec, jcfg.d_model)
    max_len = s_dec + 8
    jfwd, jloss, jpre, jdec = _jax_fns(jcfg, max_len)
    routed = _count_flash(monkeypatch)
    tol, ctol = TOL[dtype], CACHE_TOL[dtype]

    _close(te.forward(tp, bt, tcfg)[0], jfwd(jp, bj), tol, "forward")
    _close(te.loss_fn(tp, bt, tcfg), jloss(jp, bj),
           tol if dtype == "float32" else dict(rtol=2e-2, atol=0), "loss")
    logits, cache, pos = te.prefill(tp, bt, tcfg, max_len=max_len)
    jlogits, jcache, jpos = jpre(jp, bj)
    assert pos == int(jpos) == s_dec
    _close(logits, jlogits, tol, "prefill logits")
    _close(cache["enc_out"], jcache["enc_out"], ctol, "enc_out")
    # a pass: n_enc full self-attentions (S_enc >= 1024), n_dec causal
    # self-attentions (S_dec >= 1024) and n_dec full cross-attentions
    # (either length >= 1024); forward, loss_fn and prefill are 3 passes
    n_enc, n_dec = jcfg.n_enc_layers, jcfg.n_layers
    per_pass = ([False] * n_enc * (s_enc >= 1024)
                + [True, False] * n_dec * (s_dec >= 1024)
                + [False] * n_dec * (s_dec < 1024 <= s_enc))
    assert sorted(routed) == sorted(per_pass * 3)
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        logits, cache = te.decode_step(tp, cache, torch.tensor(tok), pos + i,
                                       tcfg)
        jlogits, jcache = jdec(jp, jcache, tok, jnp.int32(pos + i))
        _close(logits, jlogits, tol, f"decode step {i}")
    assert len(routed) == 3 * len(per_pass)        # decode: einsum only
    for key in ("k", "v"):
        _close(cache["self"][key], jcache["self"][key], ctol, key)


def test_loss_gradients_match_jax():
    """Float32 gradients of ``loss_fn`` through the encoder, the decoder's
    self- and cross-attention, every leaf."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(seed=1)
    bj, bt = _batch(np.random.default_rng(11), 48, 40, jcfg.d_model)
    jgrads = jax.grad(functools.partial(je.loss_fn, cfg=jcfg))(jp, bj)
    loss, grads = tsteps.value_and_grad(
        functools.partial(te.loss_fn, cfg=tcfg), tp, bt)
    _close(loss, je.loss_fn(jp, bj, jcfg), TOL["float32"], "loss")
    for i, (g, jg) in enumerate(zip(tree_leaves(grads),
                                    jax.tree.leaves(jgrads))):
        assert g.shape == jg.shape, i
        assert _rel(_np(g), _np(jg)) <= GRAD_RL2, (i, _rel(_np(g), _np(jg)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_1100_queries_against_4096_frames(dtype,
                                                          monkeypatch):
    """S = 1100 decoder positions against 4096 encoder frames: the port
    launches (here: the plain version of) the kernel once, full; the JAX
    package takes einsum + softmax (1100 is no multiple of its 512-row
    block).  Same function, other rounding."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params()
    jpl = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross_attn"])
    tpl = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 1100, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((1, 4096, jcfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    routed = _count_flash(monkeypatch)
    pos = np.arange(1100)
    got, cache = tl.attention_apply(
        tpl, torch.tensor(x).to(tdt), tcfg, torch.tensor(pos),
        cross_kv=torch.tensor(enc).to(tdt))
    want, _ = jl.attention_apply(
        jpl, jnp.asarray(x).astype(jdt), jcfg, jnp.asarray(pos),
        cross_kv=jnp.asarray(enc).astype(jdt), causal=False)
    assert routed == [False] and cache is None
    assert got.shape == (1, 1100, jcfg.d_model)
    _close(got, want, TOL[dtype])


def test_cross_attention_ignores_cache_rope_and_mask():
    """With ``cross_kv`` given, a cache and a causal flag change nothing:
    keys and values come from the encoder output, unrotated and unmasked,
    and no cache is written."""
    _, tcfg = _cfgs("float32")
    _, tp = _params()
    tpl = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((2, 5, 128)), dtype=torch.float32)
    enc = torch.tensor(rng.standard_normal((2, 7, 128)), dtype=torch.float32)
    plain, _ = tl.attention_apply(tpl, x, tcfg, torch.arange(5), cross_kv=enc)
    cache = tl.init_kv_cache(tcfg, 2, 16)
    other, out_cache = tl.attention_apply(
        tpl, x, tcfg, torch.arange(3, 8), kv_cache=cache, cache_pos=3,
        cross_kv=enc, causal=True)
    assert out_cache is None and not cache["k"].any()
    torch.testing.assert_close(other, plain, rtol=0, atol=0)
