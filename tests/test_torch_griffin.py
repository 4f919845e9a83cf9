"""The port's griffin family (models/griffin.py, configs/recurrentgemma_9b.py,
its registry entry, convert.lm_params_from_tree and launch/serve.py)
against the JAX package on the CPU, on the same numpy-made prompts and the
JAX package's own random parameters.

The reduced config has window 32, so a prompt of 64 tokens is longer than
the window: the prefill's window mask and the ring cache both matter.  At
S = 1024 both packages run the blockwise attention; at S = 1100 the JAX
package runs einsum + softmax (its route also asks for block-divisible
lengths) and the port the blockwise plain version, the same function.

Tolerances, float32 compute: rtol 1e-5 / atol 1e-5 on logits and
activations (both sides compute in float32, summing in other orders, and
the JAX package's RG-LRU is an associative scan where the port's is
sequential; gaps read up to 2.0e-6), atol 5e-5 on the states (ring keys
and values up to ~4, conv buffers up to ~4.5; gaps read up to 1.5e-5).
bfloat16 compute: rtol 2e-2 / atol 5e-2 on logits (activations are
rounded to bfloat16 at every matmul, at other places in the two
frameworks; gaps read up to 0.034 on logits of magnitude ~1, over the
2 x 1100 x 512 logits of the forward at S = 1100), and atol 0.1 on the
states (entries reach ~4, where one bfloat16 ulp is 0.016 to 0.03, and
later layers read activations that already differ by an ulp; gaps read up
to 0.07).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import recurrentgemma_9b as jcfgs  # noqa: E402
from repro.models import griffin as jg  # noqa: E402
from repro.models.layers import rms_norm as jrms_norm  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as tcfgs  # noqa: E402
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import griffin as tg  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}
STATE_TOL = {"float32": dict(rtol=1e-5, atol=5e-5),
             "bfloat16": dict(rtol=2e-2, atol=0.1)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(jnp.asarray(x).astype(jnp.float32)),
                      np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _cfgs(dtype, n_layers=3):
    """(JAX, port) reduced configs computing in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jcfgs.REDUCED, compute_dtype=jdt,
                                n_layers=n_layers),
            dataclasses.replace(tcfgs.REDUCED, compute_dtype=tdt,
                                n_layers=n_layers))


def _params(jcfg, seed=0):
    jp = jg.init(jax.random.PRNGKey(seed), jcfg)
    return jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _jax_fwd_logits(params, tokens, cfg):
    """tests/test_consistency.py's ``_fwd_logits`` for griffin."""
    x = params["embed"]["tok"].astype(cfg.compute_dtype)[tokens]
    states = jg.init_states(cfg, tokens.shape[0])
    x, _ = jg._stack_forward(params, x, cfg, states,
                             jnp.arange(tokens.shape[1]))
    x = jrms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"]["tok"].astype(cfg.compute_dtype).T


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    return (jax.jit(functools.partial(_jax_fwd_logits, cfg=jcfg)),
            jax.jit(functools.partial(jg.loss_fn, cfg=jcfg)),
            jax.jit(functools.partial(jg.prefill, cfg=jcfg)),
            jax.jit(functools.partial(jg.decode_step, cfg=jcfg)))


def _close_states(got, want, tol, where):
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name == "attn":
            for kv in ("k", "v"):
                assert got[name][kv].shape == w[kv].shape
                _close(got[name][kv], w[kv], tol, f"{where} {name}.{kv}")
        else:
            for part, g, ww in zip(("h", "conv_buf"), got[name], w):
                assert g.shape == ww.shape and g.dtype == torch.float32
                _close(g, ww, tol, f"{where} {name}.{part}")


def _count_scans(monkeypatch):
    calls = []
    scan = tg.ops.rg_lru_scan
    monkeypatch.setattr(tg.ops, "rg_lru_scan",
                        lambda *a: calls.append(1) or scan(*a))
    return calls


def _check_against_jax(jcfg, tcfg, dtype, seq, monkeypatch, steps=3):
    """forward, loss_fn, prefill (logits and every state) and ``steps``
    decode steps (logits, then every state) of the port against JAX, from
    JAX's init; every recurrent layer of each full-sequence pass goes
    through ``ops.rg_lru_scan`` once, and decode never."""
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
    jfwd, jloss, jpre, jdec = _jax_fns(jcfg)
    scans = _count_scans(monkeypatch)
    tol, stol = TOL[dtype], STATE_TOL[dtype]
    batch_t, batch_j = {"tokens": torch.tensor(toks)}, {"tokens": toks}

    logits, aux = tg.forward(tp, batch_t, tcfg)
    assert logits.dtype == DTYPES[dtype][1] and float(aux) == 0.0
    _close(logits, jfwd(jp, toks), tol, "forward")
    _close(tg.loss_fn(tp, batch_t, tcfg), jloss(jp, batch_j), tol, "loss")
    logits, states, pos = tg.prefill(tp, batch_t, tcfg)
    jlogits, jstates, jpos = jpre(jp, batch_j)
    assert pos == int(jpos) == seq and logits.shape == (2, 1, jcfg.vocab)
    _close(logits, jlogits, tol, "prefill logits")
    _close_states(states, jstates, stol, "prefill")
    n_rec = 2 * (jcfg.n_layers // 3) + jcfg.n_layers % 3
    assert len(scans) == 3 * n_rec
    for i in range(steps):
        tok = rng.integers(0, jcfg.vocab, 2).astype(np.int32)
        logits, states = tg.decode_step(tp, states, torch.tensor(tok),
                                        pos + i, tcfg)
        jlogits, jstates = jdec(jp, jstates, tok, jnp.int32(pos + i))
        _close(logits, jlogits, tol, f"decode step {i}")
    _close_states(states, jstates, stol, f"after {steps} decode steps")
    assert len(scans) == 3 * n_rec


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 1024, 1100],
                         ids=["window", "blockwise", "ragged"])
def test_griffin_matches_jax(seq, dtype, monkeypatch):
    jcfg, tcfg = _cfgs(dtype)
    _check_against_jax(jcfg, tcfg, dtype, seq, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_griffin_tail_layers_match_jax(dtype, monkeypatch):
    """5 layers = 1 group + a 2-layer recurrent tail (the full config's 38 =
    12 x 3 + 2), with a prompt shorter than the window, so decode attends
    over a ring whose later slots are still empty."""
    jcfg, tcfg = _cfgs(dtype, n_layers=5)
    _check_against_jax(jcfg, tcfg, dtype, 20, monkeypatch, steps=2)


@pytest.mark.parametrize("prefix", [12, 40])
def test_prefill_decode_matches_forward(prefix):
    """The port's own invariant (tests/test_consistency.py for the JAX
    package), float32, with a prefix shorter than the window (empty ring
    slots must be masked) and longer (the ring wraps): stepwise decode from
    the prefill's states reproduces the full-sequence forward's logits at
    every position.  atol 1e-5 (gaps read ~1e-6: decode attends over the
    ring cache, forward over the masked sequence)."""
    _, tcfg = _cfgs("float32")
    _, tp = _params(_cfgs("float32")[0], seed=1)
    steps = 6
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, prefix + steps)), dtype=torch.int32)
    full, _ = tg.forward(tp, {"tokens": toks}, tcfg)
    logits, states, pos = tg.prefill(tp, {"tokens": toks[:, :prefix]}, tcfg)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, prefix - 1].numpy(), rtol=1e-5,
                               atol=1e-5)
    for i in range(steps):
        logits, states = tg.decode_step(tp, states, toks[:, prefix + i],
                                        pos + i, tcfg)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, prefix + i].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# config, registry, params, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_config_fields_match_jax(which):
    jcfg, tcfg = getattr(jcfgs, which), getattr(tcfgs, which)
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert jf.keys() == tf.keys()
    for name in jf:
        if name.endswith("_dtype"):
            assert str(tf[name]).rsplit(".", 1)[-1] == \
                jnp.dtype(jf[name]).name, name
        else:
            assert tf[name] == jf[name], name
    assert (tcfg.head_dim, tcfg.q_per_kv) == (jcfg.head_dim, jcfg.q_per_kv)
    assert tg._layout(tcfg) == jg._layout(jcfg)


def test_registry_builds_griffin():
    api = treg.build("recurrentgemma-9b", reduced=True)
    assert api.cfg == tcfgs.REDUCED and api.name == "recurrentgemma-9b"
    gen = torch.Generator()
    gen.manual_seed(0)
    params = api.init(gen)
    toks = torch.randint(0, api.cfg.vocab, (1, 12), generator=gen)
    logits, _ = api.forward(params, {"tokens": toks})
    torch.testing.assert_close(logits, tg.forward(params, {"tokens": toks},
                                                  api.cfg)[0])
    last, states, pos = api.prefill(params, {"tokens": toks}, max_len=20)
    step, _ = api.decode_step(params, states, toks[:, -1], pos)
    assert step.shape == last.shape == (1, 1, api.cfg.vocab)
    assert torch.isfinite(api.loss_fn(params, {"tokens": toks}))


def test_port_init_has_the_jax_tree():
    """The port's own init draws the JAX package's tree: the same nesting,
    shapes and dtypes, the [G]-stacked groups included."""
    jcfg, tcfg = _cfgs("float32", n_layers=5)
    shapes = jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = tg.init(gen, tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(mine))
    for path, leaf in flat_j:
        t = mine
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).rsplit(".", 1)[-1] == leaf.dtype.name, path
    lam = mine["groups"]["rec0"]["lam"]
    assert lam.dtype == torch.float32 and 0 <= lam.min() < lam.max() < 1


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_lm_params_from_tree_carries_griffin_params():
    jcfg, _ = _cfgs("float32", n_layers=5)
    jp = jg.init(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_tree(tree)
    assert tp.keys() == tree.keys()
    assert {"tail_rec0", "tail_rec1", "tail_mlp0", "tail_mlp1"} <= tp.keys()
    w = tree["groups"]["attn"]["wkv"]
    assert tp["groups"]["attn"]["wkv"].shape == w.shape
    np.testing.assert_array_equal(tp["groups"]["rec1"]["lam"].numpy(),
                                  tree["groups"]["rec1"]["lam"])
    np.testing.assert_array_equal(tp["tail_rec1"]["conv"].numpy(),
                                  tree["tail_rec1"]["conv"])
    bf = lm_params_from_tree(
        jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp))
    leaf = bf["groups"]["mlp2"]["w_down"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(jp["groups"]["mlp2"]["w_down"].astype(jnp.bfloat16),
                   np.float32))


def test_serve_main_runs_griffin_on_the_cpu(capsys):
    args = ["--device", "cpu", "--arch", "recurrentgemma-9b", "--reduced",
            "--batch", "2", "--prompt-len", "40", "--decode-steps", "3",
            "--seed", "4"]
    out = serve.main(args)
    assert out["tokens"].shape == (2, 4) and out["device"] == "cpu"
    assert torch.isfinite(out["logits"]).all()
    assert (out["tokens"] >= 0).all() and (out["tokens"] < 512).all()
    text = capsys.readouterr().out
    assert "[recurrentgemma-9b] prefill: 2x40 tokens" in text
    np.testing.assert_array_equal(serve.main(args)["tokens"], out["tokens"])
