"""The port's moe and vlm families (models/layers.py's MoE layer and head-
width route, models/transformer.py, configs/{phi3_5_moe, kimi_k2,
llava_next_34b}.py) against the JAX package on the CPU, from the JAX
package's own random parameters (``convert.lm_params_from_tree``) and the
same numpy-made inputs.

At S = 64 both packages run einsum + softmax attention; at S = 1024 (for
llava: 8 patches + 1016 text tokens) the port sends every layer's
attention through ``ops.flash_attention`` (counted here) and the JAX
package runs its blockwise jnp function.  Routing is exact: the same
experts, the same capacity and the same dropped assignments, so the
outputs differ only by rounding.

Tolerances, float32 compute: rtol 1e-5 / atol 1e-5 on logits, the loss
and the MoE auxiliary loss (both sides sum in float32 in other orders;
gaps read up to 4.3e-6 on logits of magnitude ~4), atol 5e-5 on the KV
cache; gradients of ``loss_fn`` within a relative L2 of 1e-5 per leaf
(read up to 1.5e-6).
bfloat16 compute (activations rounded to bfloat16 at every matmul, in
other places in the two frameworks): the vlm elementwise, rtol 2e-2 /
atol 6e-2 on logits (beyond the rtol part the gaps read up to 0.052, over
2 x 1024 x 512 logits) and atol 0.1 on the cache; moe logits and caches
within an error budget against the float32 reference, since routing is a
discrete function of rounded activations (``test_family_matches_jax``
says how), the loss and aux within rtol 2e-2.  The MoE layer alone: rtol
1e-5 / atol 1e-5 in float32, and the routing (expert indices, kept
assignments) exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=5e-5),
             "bfloat16": dict(rtol=2e-2, atol=0.1)}
GRAD_RL2 = 1e-5
VLM_BF16_TOL = dict(rtol=2e-2, atol=6e-2)


def BF16_BUDGET(jax_distance: float) -> float:
    return 2 * jax_distance + 0.01


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "llava-next-34b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(arch, dtype, **changes):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jreg.build(arch, reduced=True).cfg,
                                compute_dtype=jdt, **changes),
            dataclasses.replace(treg.build(arch, reduced=True).cfg,
                                compute_dtype=tdt, **changes))


def _params(jcfg, seed=0):
    jp = jt.init(jax.random.PRNGKey(seed), jcfg)
    return jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _batch(cfg, seq, rng, b=2):
    """(JAX batch, port batch): a vlm's ``seq`` counts its patches."""
    text = seq - cfg.n_patches if cfg.family == "vlm" else seq
    toks = rng.integers(0, cfg.vocab, (b, text)).astype(np.int32)
    bj, bt = {"tokens": toks}, {"tokens": torch.tensor(toks)}
    if cfg.family == "vlm":
        pe = rng.standard_normal((b, cfg.n_patches, cfg.patch_embed_dim))
        bj["patch_embeds"] = jnp.asarray(pe, jnp.bfloat16)
        bt["patch_embeds"] = torch.tensor(_np(bj["patch_embeds"])).to(
            torch.bfloat16)
    return bj, bt


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, max_len):
    return (jax.jit(functools.partial(jt.forward, cfg=jcfg)),
            jax.jit(functools.partial(jt.loss_fn, cfg=jcfg)),
            jax.jit(functools.partial(jt.prefill, cfg=jcfg, max_len=max_len)),
            jax.jit(functools.partial(jt.decode_step, cfg=jcfg)))


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

def _run_port(tp, bt, tcfg, seq, decode_toks):
    """The port's forward (logits, aux), loss, prefill logits and cache and
    the logits of decode steps fed ``decode_toks``."""
    logits, aux = tt.forward(tp, bt, tcfg)
    out = {"forward": logits, "aux": aux, "loss": tt.loss_fn(tp, bt, tcfg)}
    out["prefill"], cache, pos = tt.prefill(tp, bt, tcfg, max_len=seq + 8)
    assert pos == seq
    for i, tok in enumerate(decode_toks):
        out[f"decode {i}"], cache = tt.decode_step(
            tp, cache, torch.tensor(tok), pos + i, tcfg)
    out.update(cache)
    return out


def _run_jax(jp, bj, jcfg, seq, decode_toks):
    jfwd, jloss, jpre, jdec = _jax_fns(jcfg, seq + 8)
    out = dict(zip(("forward", "aux"), jfwd(jp, bj)))
    out["loss"] = jloss(jp, bj)
    out["prefill"], cache, pos = jpre(jp, bj)
    assert int(pos) == seq
    for i, tok in enumerate(decode_toks):
        out[f"decode {i}"], cache = jdec(jp, cache, tok, jnp.int32(pos + i))
    out.update(cache)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 1024], ids=["einsum", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_matches_jax(arch, seq, dtype, monkeypatch):
    """forward (logits and the summed MoE aux), loss, prefill logits and
    cache, and three decode steps; a vlm decodes on at position P + text.

    In bfloat16 an MoE token whose k-th and (k+1)-th router probabilities
    lie closer than the activations' rounding can take another expert in
    either framework (and shift which tokens overflow): JAX's own bfloat16
    run does so against its float32 run.  So moe logits and caches are held
    to an error budget, not elementwise: the relative L2 distance of the
    port's bfloat16 result from the float32 reference (the port's float32
    run, held to JAX's above) is at most ``BF16_BUDGET`` = 2 x JAX's own
    bfloat16 distance + 0.01 (read: at most 1.62 x, forward, prefill and
    decode, S = 64 and 1024); the loss and aux elementwise, rtol 2e-2.  The
    vlm routes nothing and is held elementwise: rtol 2e-2 / atol 6e-2 on
    logits (the atol beyond the rtol part read up to 0.052) and atol 0.1
    on the cache."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(seq)
    bj, bt = _batch(jcfg, seq, rng)
    toks = [rng.integers(0, jcfg.vocab, 2).astype(np.int32) for _ in range(3)]
    routed = []
    flash = tl.ops.flash_attention
    monkeypatch.setattr(tl.ops, "flash_attention",
                        lambda *a: routed.append(1) or flash(*a))
    got = _run_port(tp, bt, tcfg, seq, toks)
    # one per layer in each of forward, loss_fn's forward and prefill
    assert len(routed) == (3 * jcfg.n_layers if seq >= 1024 else 0)
    want = _run_jax(jp, bj, jcfg, seq, toks)
    assert got["forward"].shape == want["forward"].shape == (
        2, seq, jcfg.vocab)
    assert got["k"].dtype == DTYPES[dtype][1]
    assert (float(got["aux"]) > 0) == (jcfg.moe is not None)
    scalars = ("loss", "aux")
    if dtype == "float32" or jcfg.moe is None:
        tol = TOL[dtype] if dtype == "float32" else VLM_BF16_TOL
        for name in got:
            t = (CACHE_TOL[dtype] if name in ("k", "v")
                 else TOL[dtype] if name in scalars else tol)
            _close(got[name], want[name], t, name)
        return
    _, tcfg32 = _cfgs(arch, "float32")
    ref = _run_port(tp, bt, tcfg32, seq, toks)
    for name in got:
        if name in scalars:
            _close(got[name], want[name], dict(rtol=2e-2, atol=1e-3), name)
            continue
        mine, theirs = _rel(_np(got[name]), _np(ref[name])), \
            _rel(_np(want[name]), _np(ref[name]))
        assert mine <= BF16_BUDGET(theirs), (name, mine, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    """Float32 gradients of ``loss_fn`` (the aux included for moe) for every
    leaf: the router's through the gates and the aux, the experts' through
    the kept assignments, a vlm's ``patch_proj`` through the image prefix."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _params(jcfg, seed=1)
    bj, bt = _batch(jcfg, 48, np.random.default_rng(7))
    jgrads = jax.grad(functools.partial(jt.loss_fn, cfg=jcfg))(jp, bj)
    loss, grads = tsteps.value_and_grad(
        functools.partial(tt.loss_fn, cfg=tcfg), tp, bt)
    _close(loss, jt.loss_fn(jp, bj, jcfg), TOL["float32"], "loss")
    for i, (g, jg) in enumerate(zip(tree_leaves(grads),
                                    jax.tree.leaves(jgrads))):
        assert g.shape == jg.shape, i
        assert _rel(_np(g), _np(jg)) <= GRAD_RL2, (i, _rel(_np(g), _np(jg)))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_pair(arch, seed=0, **moe_changes):
    jcfg, tcfg = _cfgs(arch, "float32")
    if moe_changes:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_changes))
    jp = jl.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _jax_routing(jp, x, cfg):
    """The JAX package's routing of ``moe_apply``, step by step: (expert
    indices [T, k], kept [T * k])."""
    mc = cfg.moe
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, mc.top_k)
    cap = int(max(1, round(xt.shape[0] * mc.top_k / mc.n_experts
                           * mc.capacity_factor)))
    onehot = jax.nn.one_hot(idx.reshape(-1), mc.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot,
                              idx.reshape(-1)[:, None], axis=1)[:, 0]
    return np.asarray(idx), np.asarray(pos < cap)


def _check_moe(jcfg, tcfg, jp, tp, x):
    out, aux = tl.moe_apply(tp, torch.tensor(x), tcfg)
    jout, jaux = jl.moe_apply(jp, jnp.asarray(x), jcfg)
    _close(out, jout, TOL["float32"], "moe out")
    _close(aux, jaux, TOL["float32"], "moe aux")
    _, idx = tl.moe_route(torch.tensor(x).reshape(-1, x.shape[-1]),
                          tp["router"], tcfg.moe)
    _, keep, _ = tl.moe_slots(idx, tcfg.moe)
    jidx, jkeep = _jax_routing(jp, x, jcfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    return idx.numpy(), keep.numpy(), out


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_tied_router_picks_the_lowest_experts_and_drops_like_jax(arch):
    """A router of zeros: every probability is 1/E, so top-k takes experts
    0..k-1 for every token (``lax.top_k`` on ties), experts 0..k-1 fill up
    in token order and every later token is dropped; without a shared
    expert a dropped token's output is exactly 0."""
    jcfg, tcfg, jp, tp = _moe_pair(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    idx, keep, out = _check_moe(jcfg, tcfg, jp, tp, x)
    mc = jcfg.moe
    t = 2 * 24
    cap = tl.moe_capacity(t, tcfg.moe)
    assert cap < t
    np.testing.assert_array_equal(idx, np.tile(np.arange(mc.top_k), (t, 1)))
    np.testing.assert_array_equal(keep, np.repeat(np.arange(t) < cap,
                                                  mc.top_k))
    if not mc.n_shared:
        assert not out.reshape(t, -1)[cap:].any()
        assert out.reshape(t, -1)[:cap].abs().amax(-1).min() > 0


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_moe_layer_matches_jax(arch, capacity_factor):
    """A random router; at capacity factor 0.5 a share of the assignments
    overflows and is dropped, the same ones on both sides.  kimi-k2's
    reduced config has a shared expert (``n_shared`` = 1)."""
    jcfg, tcfg, jp, tp = _moe_pair(arch, seed=2,
                                   capacity_factor=capacity_factor)
    x = np.random.default_rng(4).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    _, keep, _ = _check_moe(jcfg, tcfg, jp, tp, x)
    if capacity_factor < 1:
        assert 0 < keep.sum() < keep.size
    assert ("shared" in tp) == (arch == "kimi-k2-1t-a32b")


def test_capacity_rounds_half_to_even_as_python():
    mc = tl.MoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                      capacity_factor=1.0)
    # T * k / E = 2.5 and 3.5: Python's round gives 2 and 4
    assert [tl.moe_capacity(t, mc) for t in (10, 14, 1, 0)] == [2, 4, 1, 1]
    for t in (10, 14, 3000, 16384):
        for cf in (1.25, 0.5, 1.0):
            m = dataclasses.replace(mc, capacity_factor=cf, top_k=2,
                                    n_experts=16)
            assert tl.moe_capacity(t, m) == int(max(1, round(t * 2 / 16
                                                             * cf)))


# ---------------------------------------------------------------------------
# the head-width route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_the_kernel_does_not_take_runs_plain(dtype, monkeypatch):
    """dh = 112 (kimi-k2's 7168 / 64 at full width): at S = 1024 the prefill
    and the forward take the plain blockwise ``layers.flash_attention``,
    decided before any launch, and match the JAX package."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b", dtype, d_model=224, n_heads=2,
                       n_kv_heads=1)
    assert tcfg.head_dim == 112 and 112 not in tl.HEAD_DIMS
    jp, tp = _params(jcfg)
    jpl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tpl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    monkeypatch.setattr(tl.ops, "flash_attention",
                        lambda *a: pytest.fail("dh 112 reached the kernel"))
    x = np.random.default_rng(5).standard_normal(
        (1, 1024, 224)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(DTYPES[dtype][0]), torch.tensor(x).to(
        DTYPES[dtype][1])
    pos = np.arange(1024)
    got, _ = tl.attention_apply(tpl, xt, tcfg, torch.tensor(pos))
    want, _ = jl.attention_apply(jpl, xj, jcfg, jnp.asarray(pos))
    _close(got, want, TOL[dtype])
    cache = tl.init_kv_cache(tcfg, 1, 1030)
    got, _ = tl.attention_apply(tpl, xt, tcfg, torch.tensor(pos),
                                kv_cache=cache, cache_pos=0)
    _close(got, want, TOL[dtype])
