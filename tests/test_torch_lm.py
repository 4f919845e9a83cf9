"""The port's dense LM stack (models/layers.py, models/transformer.py,
models/registry.py, configs/, convert.lm_params_from_tree,
launch/serve.py) against the JAX package on the CPU, on the same numpy-made
inputs and the JAX package's own random parameters.

Tolerances, float32 compute: rtol 1e-5 / atol 1e-5 on activations and
logits (both sides compute in float32, summing in other orders; the
largest gaps read ~1.5e-6), atol 5e-5 on the KV cache (keys and values of
magnitude up to ~10 carry the matmuls' ulps; read ~1.4e-5).  bfloat16
compute: rtol 2e-2 / atol 3e-2 (activations are rounded to bfloat16 at
every matmul, one ulp is 2**-8 relative, and the two frameworks round at
different places; gaps read up to 0.016 on logits of magnitude ~1), and
atol 0.1 on the KV cache (entries reach ~5, where one bfloat16 ulp is
0.03, and the second layer's keys and values come from activations that
already differ by an ulp; gaps read up to 0.051).
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import (codeqwen1_5_7b as j_codeqwen,  # noqa: E402
                           kimi_k2 as j_kimi, llava_next_34b as j_llava,
                           phi3_5_moe as j_phi, qwen3_1_7b as j_qwen3,
                           seamless_m4t_medium as j_seamless,
                           smollm_135m as j_smollm, xlstm_1_3b as j_xlstm,
                           yi_9b as j_yi)
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.sim import engine_jax  # noqa: E402
from repro.sim.scenarios import get_scenario as jget_scenario  # noqa: E402
from repro_torch.configs import (codeqwen1_5_7b as t_codeqwen,  # noqa: E402
                                 kimi_k2 as t_kimi,
                                 llava_next_34b as t_llava,
                                 phi3_5_moe as t_phi, qwen3_1_7b as t_qwen3,
                                 seamless_m4t_medium as t_seamless,
                                 smollm_135m as t_smollm,
                                 xlstm_1_3b as t_xlstm, yi_9b as t_yi)
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sim import engine as tengine  # noqa: E402
from repro_torch.sim.scenarios import get_scenario  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=3e-2)}
CACHE_TOL = {"float32": dict(rtol=1e-5, atol=5e-5),
             "bfloat16": dict(rtol=2e-2, atol=0.1)}
CONFIGS = {"smollm-135m": (j_smollm, t_smollm),
           "qwen3-1.7b": (j_qwen3, t_qwen3), "yi-9b": (j_yi, t_yi),
           "codeqwen1.5-7b": (j_codeqwen, t_codeqwen),
           "phi3.5-moe-42b-a6.6b": (j_phi, t_phi),
           "kimi-k2-1t-a32b": (j_kimi, t_kimi),
           "llava-next-34b": (j_llava, t_llava),
           "xlstm-1.3b": (j_xlstm, t_xlstm),
           "seamless-m4t-medium": (j_seamless, t_seamless)}
NEW_FAMILIES = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "llava-next-34b",
                "xlstm-1.3b", "seamless-m4t-medium")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _cfgs(arch, dtype):
    """(JAX, port) reduced configs of ``arch`` computing in ``dtype``."""
    jm, tm = CONFIGS[arch]
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jm.REDUCED, compute_dtype=jdt),
            dataclasses.replace(tm.REDUCED, compute_dtype=tdt))


def _params(jcfg, seed=0):
    jp = jt.init(jax.random.PRNGKey(seed), jcfg)
    return jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _dtype_name(d):
    return str(d).rsplit(".", 1)[-1] if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_config_fields_match_jax(arch, which):
    jcfg, tcfg = (getattr(m, which) for m in CONFIGS[arch])
    jf = dataclasses.asdict(jcfg)
    tf = dataclasses.asdict(tcfg)
    assert jf.keys() == tf.keys()
    for name in jf:
        if name.endswith("_dtype"):
            assert _dtype_name(tf[name]) == _dtype_name(jf[name]), name
        else:
            assert tf[name] == jf[name], name
    assert (tcfg.head_dim, tcfg.q_per_kv) == (jcfg.head_dim, jcfg.q_per_kv)


def test_registry_builds_every_arch_reduced_with_its_family():
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ARCH_MODULES == jreg.ARCH_MODULES
    for arch in treg.ARCH_MODULES:
        api = treg.build(arch, reduced=True)
        assert api.cfg.family == treg.ARCH_FAMILIES[arch] and api.name == arch
        assert api.cfg.family == jreg.build(arch, reduced=True).cfg.family
        assert type(api.init(torch.Generator().manual_seed(0))) is dict


@pytest.mark.parametrize("arch", list(treg.ARCH_MODULES))
def test_param_counts_match_jax(arch):
    """(total, active) of every full config, from shapes on the ``meta``
    device: the full kimi-k2 (1.03e12 parameters) allocates nothing."""
    api = treg.build(arch)
    want = jreg.build(arch).param_counts()
    assert api.param_counts() == tuple(int(n) for n in want)
    assert all(t.device.type == "meta"
               for t in tree_leaves(api.param_shapes()))


def test_registry_cuts_depth_and_keeps_width():
    full = treg.build("phi3.5-moe-42b-a6.6b")
    cut = treg.build("phi3.5-moe-42b-a6.6b", n_layers=8)
    assert cut.cfg == dataclasses.replace(full.cfg, n_layers=8)
    total, _ = cut.param_counts()
    per_layer = (full.param_counts()[0] - total) // 24
    assert total + 24 * per_layer == full.param_counts()[0]


def test_lm_params_from_tree_keeps_layout_and_bfloat16():
    jcfg, _ = _cfgs("qwen3-1.7b", "float32")
    jp = jt.init(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_tree(tree)
    wq = tree["layers"]["attn"]["wq"]
    assert tp["layers"]["attn"]["wq"].shape == wq.shape
    assert torch.equal(tp["embed"]["tok"], torch.tensor(tree["embed"]["tok"]))
    bf = lm_params_from_tree(
        jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp))
    leaf = bf["layers"]["mlp"]["w_up"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(jp["layers"]["mlp"]["w_up"].astype(jnp.bfloat16),
                   np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    jdt, tdt = DTYPES[dtype]
    got = tl.rms_norm(torch.tensor(x).to(tdt), torch.tensor(scale), 1e-6)
    want = jl.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale), 1e-6)
    assert got.dtype == tdt
    _close(got, want, TOL[dtype])


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x, scale, bias = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((3, 4, 40), (40,), (40,)))
    got = tl.layer_norm(torch.tensor(x), torch.tensor(scale),
                        torch.tensor(bias), 1e-5)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 1e-5)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_jax(batched_positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    if batched_positions:
        pos = np.stack([pos, pos + 3])
    got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_attention_apply_matches_jax(mode):
    """Reduced qwen3 (qk-norm, GQA with G = 2), float32; the cache is
    written in place on the port's side and returned on both."""
    jcfg, tcfg = _cfgs("qwen3-1.7b", "float32")
    jp, tp = _params(jcfg)
    jpl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tpl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(2)
    s = 1 if mode == "decode" else 24
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    kw_j, kw_t, pos = {}, {}, np.arange(s)
    if mode != "no_cache":
        max_len, cache_pos = 40, (17 if mode == "decode" else 0)
        pos = np.arange(cache_pos, cache_pos + s)
        k0 = rng.standard_normal((2, max_len, jcfg.n_kv_heads,
                                  jcfg.head_dim)).astype(np.float32)
        v0 = rng.standard_normal(k0.shape).astype(np.float32)
        kw_j = dict(kv_cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                    cache_pos=cache_pos)
        kw_t = dict(kv_cache={"k": torch.tensor(k0), "v": torch.tensor(v0)},
                    cache_pos=cache_pos)
    got, tcache = tl.attention_apply(tpl, torch.tensor(x), tcfg,
                                     torch.tensor(pos), **kw_t)
    want, jcache = jl.attention_apply(jpl, jnp.asarray(x), jcfg,
                                      jnp.asarray(pos), **kw_j)
    _close(got, want, TOL["float32"])
    if mode == "no_cache":
        assert tcache is None and jcache is None
    else:
        assert tcache is kw_t["kv_cache"]            # written in place
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], CACHE_TOL["float32"], key)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, max_len):
    return (jax.jit(functools.partial(jt.forward, cfg=jcfg)),
            jax.jit(functools.partial(jt.loss_fn, cfg=jcfg)),
            jax.jit(functools.partial(jt.prefill, cfg=jcfg, max_len=max_len)),
            jax.jit(functools.partial(jt.decode_step, cfg=jcfg)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 1024], ids=["naive", "flash"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-1.7b"])
def test_lm_matches_jax(arch, seq, dtype, monkeypatch):
    """forward, loss, prefill and three decode steps of the reduced model
    from the JAX package's init.  At S = 1024 the port routes every layer's
    attention through ``ops.flash_attention`` (counted); the JAX package
    runs its blockwise jnp function over a 2048-slot cache there and its
    einsum path at S = 64."""
    _check_lm_against_jax(arch, seq, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_matches_jax_at_a_length_no_block_divides(dtype, monkeypatch):
    """S = 1100 (>= 1024, but no multiple of the 512-row block): the JAX
    package's route rule also asks for block-divisible lengths, so it runs
    einsum + softmax over its 2048-slot cache, while the port's prefill
    sends every layer through ``ops.flash_attention`` (its plain blockwise
    version here).  Same function, other rounding: held to the same
    tolerances (gaps read up to 1.3e-6 in float32 and 0.014 in
    bfloat16)."""
    _check_lm_against_jax("smollm-135m", 1100, dtype, monkeypatch)


def _check_lm_against_jax(arch, seq, dtype, monkeypatch):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
    max_len = 2048 if seq >= 1024 else seq + 8
    jfwd, jloss, jpre, jdec = _jax_fns(jcfg, max_len)
    routed = []
    flash = tl.ops.flash_attention
    monkeypatch.setattr(tl.ops, "flash_attention",
                        lambda *a: routed.append(1) or flash(*a))
    tol, ctol = TOL[dtype], CACHE_TOL[dtype]
    batch_t, batch_j = {"tokens": torch.tensor(toks)}, {"tokens": toks}

    got, _ = tt.forward(tp, batch_t, tcfg)
    _close(got, jfwd(jp, batch_j)[0], tol, "forward")
    _close(tt.loss_fn(tp, batch_t, tcfg), jloss(jp, batch_j), tol, "loss")
    logits, cache, pos = tt.prefill(tp, batch_t, tcfg, max_len=max_len)
    jlogits, jcache, jpos = jpre(jp, batch_j)
    assert pos == int(jpos) == seq
    assert cache["k"].shape == jcache["k"].shape
    assert cache["k"].dtype == DTYPES[dtype][1]
    _close(logits, jlogits, tol, "prefill logits")
    # one per layer in each of forward, loss_fn's forward and prefill
    n_flash = 3 * jcfg.n_layers if seq >= 1024 else 0
    assert len(routed) == n_flash
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        logits, cache = tt.decode_step(tp, cache, torch.tensor(tok), pos + i,
                                       tcfg)
        jlogits, jcache = jdec(jp, jcache, tok, jnp.int32(pos + i))
        _close(logits, jlogits, tol, f"decode step {i}")
    assert len(routed) == n_flash                       # decode: einsum path
    for key in ("k", "v"):
        _close(cache[key], jcache[key], ctol, f"cache {key}")


def test_serve_main_runs_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", "--batch", "2", "--prompt-len", "12",
                      "--decode-steps", "3", "--seed", "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["device"] == "cpu"
    assert torch.isfinite(out["logits"]).all()
    assert (out["tokens"] >= 0).all() and (out["tokens"] < 512).all()
    text = capsys.readouterr().out
    assert "prefill: 2x12 tokens" in text and "tok/s" in text
    again = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "12", "--decode-steps", "3", "--seed", "4"])
    np.testing.assert_array_equal(again["tokens"], out["tokens"])


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-medium",
                                  "smollm-135m"])
@pytest.mark.parametrize("prompt_len", [5, 24])
def test_make_batch_is_bitwise_jax(arch, prompt_len):
    """The same seed gives the JAX package's arrays bit for bit: a vlm's
    tokens then bfloat16 patch embeddings, an enc-dec's bfloat16 frames then
    tokens (prompt 5 is shorter than the reduced llava's 8 patches: one
    text token)."""
    got = serve.make_batch(treg.build(arch, reduced=True),
                           np.random.default_rng(7), 2, prompt_len)
    want = jserve.make_batch(jreg.build(arch, reduced=True),
                             np.random.default_rng(7), 2, prompt_len)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=name)
        else:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_main_runs_every_new_family_on_the_cpu(arch, capsys):
    argv = ["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
            "--prompt-len", "20", "--decode-steps", "3", "--seed", "5"]
    out = serve.main(argv)
    assert out["tokens"].shape == (2, 4) and out["device"] == "cpu"
    assert torch.isfinite(out["logits"]).all()
    assert torch.isfinite(out["prefill_logits"]).all()
    assert out["n_params"] == treg.build(arch, reduced=True).param_counts()[0]
    assert "tok/s" in capsys.readouterr().out
    np.testing.assert_array_equal(serve.main(argv)["tokens"], out["tokens"])


# ---------------------------------------------------------------------------
# the diurnal multiplier (fdiv + glibc's sinf, bitwise)
# ---------------------------------------------------------------------------

def test_diurnal_mult_is_bitwise_jax():
    rounds = np.arange(1, 401, dtype=np.int32)
    got = tengine.scenario_diurnal_mult(get_scenario("diurnal-drift"),
                                        torch.tensor(rounds)).numpy()
    want = np.asarray(engine_jax.scenario_diurnal_mult(
        jget_scenario("diurnal-drift"), jnp.asarray(rounds)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sinf_is_bitwise_jax_sin():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-119.0, 119.0, 200_000),
                        rng.uniform(-1e-3, 1e-3, 1000),
                        np.arange(-8, 9) * math.pi / 4]).astype(np.float32)
    got = tengine.sinf(torch.tensor(x)).numpy()
    want = np.asarray(jnp.sin(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_round_runner_diurnal_table_holds_per_round_bits():
    # a sweep's rounds index a table of multipliers made for 64 rounds and
    # then for twice as many when a round outgrows it; every round must
    # read the bits of its own per-round call
    scen = get_scenario("diurnal-drift")
    env = tengine.EnvArrays.from_scenario(
        scen, scen.build_env(8, np.random.default_rng(0)))
    runner = tengine.RoundRunner(env, torch.tensor([1.5]),
                                 policy="naive_ucb", scen=scen, s_round=2,
                                 hyper=1.0, model_bits=1e6)
    sizes = set()
    for rnd in range(1, 301):
        table = runner._diurnal_table(rnd)
        sizes.add(table.shape[0])
        got = tengine.scenario_thr_mult(scen, env.cell_id, None, rnd, table)
        want = tengine.scenario_thr_mult(scen, env.cell_id, None, rnd)
        assert got.shape == want.shape == (1, 1)
        assert got.view(torch.int32).item() == want.view(torch.int32).item()
    assert sizes == {64, 130, 262, 526}
