"""The port's xlstm family (models/xlstm.py, configs/xlstm_1_3b.py) against
the JAX package on the CPU, from the JAX package's own random parameters
(``convert.lm_params_from_tree``) and the same numpy-made prompts.  The
reduced config is 8 layers (one group of 7 mLSTM + 1 sLSTM), d_model 64,
2 heads, chunk 256.  xlstm has no attention: no length sends anything to
``ops.flash_attention`` (counted here at S = 64 and 1024).

Tolerances.  The chunkwise mLSTM divides by max(|n . q|, exp(-m)), which
amplifies the rounding of its float32 sums where n . q nearly cancels: the
JAX package's own chunk sizes 64 and 256 differ by 1.7e-4 on a cell output
of magnitude ~23, as its tests/test_models.py's rtol / atol 2e-4 allow.
So float32 compute: logits rtol 1e-4 / atol 1e-3 (gaps read up to 5.4e-4
on logits of magnitude ~5, 1.3e-4 at the prefill and decode positions),
states rtol 1e-4 / atol 2e-4 of each state's largest entry (read up to
6.7e-5 of it), the loss rtol 1e-5 (read 1.4e-7), gradients within a
relative L2 of 5e-4 per leaf (read up to 1.4e-4).  bfloat16 compute: the
exponential gates amplify one bfloat16 step of an activation to ~0.1 in
the logits (the JAX package says as much of its decode conv), so JAX's own
bfloat16 logits differ from its float32 ones by up to 0.38 (S = 1024);
the port's bfloat16 logits and states are held to an error budget, a
relative L2 distance from the float32 reference of at most 2 x JAX's own
+ 0.01 (read up to 1.4 x), and the loss within rtol 2e-2.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import xlstm_1_3b as jcfgs  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.layers import rms_norm as jrms_norm  # noqa: E402
from repro_torch.configs import xlstm_1_3b as tcfgs  # noqa: E402
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

TOL = dict(rtol=1e-4, atol=1e-3)
STATE_TOL = dict(rtol=1e-4, atol=2e-4)      # atol of the largest entry
GRAD_RL2 = 5e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def BF16_BUDGET(jax_distance: float) -> float:
    return 2 * jax_distance + 0.01


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
def _jax_params(seed=0):
    jp = jx.init(jax.random.PRNGKey(seed), jcfgs.REDUCED)
    return jp, lm_params_from_tree(jax.tree.map(np.asarray, jp))


def _jax_forward(params, tokens, cfg):
    """tests/test_consistency.py's full-sequence logits for xlstm."""
    x = params["embed"]["tok"].astype(cfg.compute_dtype)[tokens]
    x, _ = jx._stack_forward(params, x, cfg)
    x = jrms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"].astype(cfg.compute_dtype)


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    return (jax.jit(functools.partial(_jax_forward, cfg=jcfg)),
            jax.jit(functools.partial(jx.loss_fn, cfg=jcfg)),
            jax.jit(functools.partial(jx.prefill, cfg=jcfg)),
            jax.jit(functools.partial(jx.decode_step, cfg=jcfg)))


def _states(states):
    """(name, array) of every state leaf, in the same order for both."""
    for group in ("mlstm", "slstm"):
        for i, t in enumerate(states[group]):
            yield f"{group}[{i}]", t


def _run_port(tp, toks, tcfg, decode_toks):
    batch = {"tokens": torch.tensor(toks)}
    out = {"forward": tx.forward(tp, batch, tcfg)[0],
           "loss": tx.loss_fn(tp, batch, tcfg)}
    out["prefill"], states, pos = tx.prefill(tp, batch, tcfg)
    assert pos == toks.shape[1]
    out.update((f"prefill {k}", v) for k, v in _states(states))
    for i, tok in enumerate(decode_toks):
        out[f"decode {i}"], states = tx.decode_step(
            tp, states, torch.tensor(tok), pos + i, tcfg)
    out.update(_states(states))
    return out


def _run_jax(jp, toks, jcfg, decode_toks):
    jfwd, jloss, jpre, jdec = _jax_fns(jcfg)
    out = {"forward": jfwd(jp, toks), "loss": jloss(jp, {"tokens": toks})}
    out["prefill"], states, pos = jpre(jp, {"tokens": toks})
    out.update((f"prefill {k}", v) for k, v in _states(states))
    for i, tok in enumerate(decode_toks):
        out[f"decode {i}"], states = jdec(jp, states, tok, pos + i)
    out.update(_states(states))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 1024])
def test_xlstm_matches_jax(seq, dtype, monkeypatch):
    """forward, loss, prefill logits and states, three decode steps and
    the states after them.  S = 64 is one chunk of 64; S = 1024 four
    chunks of 256."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _jax_params()
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, jcfg.vocab, (2, seq)).astype(np.int32)
    dec = [rng.integers(0, jcfg.vocab, 2).astype(np.int32) for _ in range(3)]
    monkeypatch.setattr(tl.ops, "flash_attention",
                        lambda *a: pytest.fail("xlstm reached attention"))
    got = _run_port(tp, toks, tcfg, dec)
    want = _run_jax(jp, toks, jcfg, dec)
    assert got.keys() == want.keys()
    assert got["forward"].shape == (2, seq, jcfg.vocab)
    if dtype == "float32":
        for name in got:
            if name == "loss":
                _close(got[name], want[name], dict(rtol=1e-5, atol=0), name)
            elif "[" in name:              # a state: beside its largest entry
                scale = np.abs(_np(want[name])).max()
                _close(got[name], want[name],
                       dict(rtol=STATE_TOL["rtol"],
                            atol=STATE_TOL["atol"] * scale), name)
            else:
                _close(got[name], want[name], TOL, name)
        return
    _, tcfg32 = _cfgs("float32")
    ref = _run_port(tp, toks, tcfg32, dec)
    _close(got["loss"], want["loss"], dict(rtol=2e-2, atol=0), "loss")
    for name in got:
        if name != "loss":
            mine = _rel(_np(got[name]), _np(ref[name]))
            theirs = _rel(_np(want[name]), _np(ref[name]))
            assert mine <= BF16_BUDGET(theirs), (name, mine, theirs)


def test_loss_gradients_match_jax():
    """Float32 gradients of ``loss_fn`` through the chunkwise mLSTM (two
    chunks of 32) and the sLSTM loop, every leaf."""
    jcfg, tcfg = _cfgs("float32", mlstm_chunk=32)
    jp, tp = _jax_params(seed=1)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 64)).astype(
        np.int32)
    jgrads = jax.grad(functools.partial(jx.loss_fn, cfg=jcfg))(
        jp, {"tokens": toks})
    loss, grads = tsteps.value_and_grad(
        functools.partial(tx.loss_fn, cfg=tcfg), tp,
        {"tokens": torch.tensor(toks)})
    _close(loss, jx.loss_fn(jp, {"tokens": toks}, jcfg),
           dict(rtol=1e-5, atol=0), "loss")
    for i, (g, jg) in enumerate(zip(tree_leaves(grads),
                                    jax.tree.leaves(jgrads))):
        assert g.shape == jg.shape, i
        assert _rel(_np(g), _np(jg)) <= GRAD_RL2, (i, _rel(_np(g), _np(jg)))


def _cell_inputs(seed=0, b=2, s=256, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ip = rng.standard_normal((b, s, h)).astype(np.float32)
    fp = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    state = (np.zeros((b, h, d, d), np.float32),
             np.zeros((b, h, d), np.float32), np.zeros((b, h), np.float32))
    return (q, k, v, ip, fp), state


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_chunkwise_matches_jax_and_the_step_recurrence(chunk):
    """The mLSTM cell at chunk 64, 128 and 256 against the JAX package's
    ``mlstm_chunkwise`` at the same chunk and against the port's own
    step recurrence (``mlstm_decode``, one token at a time), as JAX's
    tests/test_models.py checks its own (rtol / atol 2e-4 there and
    here)."""
    args, state = _cell_inputs()
    h, st = tx.mlstm_chunkwise(*map(torch.tensor, args),
                               tuple(map(torch.tensor, state)), chunk)
    jh, jst = jx.mlstm_chunkwise(*map(jnp.asarray, args),
                                 tuple(map(jnp.asarray, state)), chunk)
    tol = dict(rtol=2e-4, atol=2e-4)
    _close(h, jh, tol, "h against JAX")
    for a, b in zip(st, jst):
        _close(a, b, tol, "state against JAX")
    seq_state = tuple(map(torch.tensor, state))
    hs = []
    q, k, v, ip, fp = map(torch.tensor, args)
    for t in range(q.shape[1]):
        ht, seq_state = tx.mlstm_decode(q[:, t], k[:, t], v[:, t], ip[:, t],
                                        fp[:, t], seq_state)
        hs.append(ht)
    _close(h, torch.stack(hs, 1), tol, "h against the recurrence")
    for a, b in zip(st, seq_state):
        _close(a, b, tol, "state against the recurrence")


def test_chunk_sizes_give_the_same_model_outputs():
    """The model's prefill logits and states at chunk 64, 128 and 256 (S =
    512): the same within the float32 tolerance."""
    _, tp = _jax_params()
    toks = torch.tensor(np.random.default_rng(2).integers(0, 512, (2, 512)))
    out = {}
    for chunk in (64, 128, 256):
        _, tcfg = _cfgs("float32", mlstm_chunk=chunk)
        logits, states, _ = tx.prefill(tp, {"tokens": toks}, tcfg)
        out[chunk] = [logits] + [t for _, t in _states(states)]
    for chunk in (64, 128):
        for a, b in zip(out[chunk], out[256]):
            scale = float(b.abs().max())
            _close(a, b, dict(rtol=STATE_TOL["rtol"],
                              atol=STATE_TOL["atol"] * scale),
                   f"chunk {chunk}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_equals_a_longer_prefill(dtype):
    """A prefill of S = 256 and 4 decode steps give the logits of the last
    position of a prefill of S + 4 = 260 (which runs as one chunk of 260);
    the decode conv runs in the compute dtype as the prefill's does.
    bfloat16: the two forms round in other places and the gates amplify it
    (gaps read up to 0.24), so each is held to the error budget against the
    float32 prefill: the decoded logits' relative L2 distance from it at
    most 2 x the longer bfloat16 prefill's + 0.01."""
    _, tp = _jax_params()
    toks = torch.tensor(np.random.default_rng(3).integers(0, 512, (2, 260)),
                        dtype=torch.int32)
    out = {}
    for dt in {"float32", dtype}:
        _, tcfg = _cfgs(dt, mlstm_chunk=512)
        logits, states, pos = tx.prefill(tp, {"tokens": toks[:, :256]}, tcfg)
        for i in range(4):
            logits, states = tx.decode_step(tp, states, toks[:, 256 + i],
                                            pos + i, tcfg)
        out[dt] = logits, tx.prefill(tp, {"tokens": toks}, tcfg)[0]
    if dtype == "float32":
        _close(*out[dtype], TOL)
    else:
        ref = _np(out["float32"][1])
        decoded, longer = (_rel(_np(x), ref) for x in out[dtype])
        assert decoded <= BF16_BUDGET(longer), (decoded, longer)


def test_a_length_the_chunk_does_not_divide_raises():
    _, tcfg = _cfgs("float32")
    _, tp = _jax_params()
    toks = torch.zeros((1, 300), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not divide"):
        tx.prefill(tp, {"tokens": toks}, tcfg)
    with pytest.raises(ValueError, match="multiple of 8"):
        tx.n_groups(dataclasses.replace(tcfg, n_layers=12))


def test_registry_builds_xlstm_with_the_jax_tree():
    """The port's ``init`` has the JAX package's tree: the same keys,
    shapes and dtypes, [G, 7] and [G] stacks."""
    api = treg.build("xlstm-1.3b", reduced=True)
    assert api.cfg.family == "xlstm"
    tp = api.init(torch.Generator().manual_seed(0))
    jp = jx.init(jax.random.PRNGKey(0), jcfgs.REDUCED)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jp))[0]
    assert len(flat_t) == len(tree_leaves(tp))
    for path, leaf in flat_t:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.float32
    assert tp["mlstm"]["w_q"].shape[:2] == (1, 7)
    assert tp["slstm"]["r"].shape[0] == 1
