"""Training through the port's kernels' autograd Functions
(kernels/ops.py) and ``launch/steps.make_train_step`` against the JAX
package on the CPU.

- ``FlashAttentionFn``'s gradient against ``jax.grad`` through JAX's
  ``flash_attention_trainable`` (the Pallas kernel in interpret mode, its
  backward the jnp blockwise path) at S = 64 and 1024, and at S = 1100 —
  which the Pallas kernel does not take (block-divisible lengths only) —
  against ``jax.grad`` of JAX's blockwise ``layers.flash_attention`` in one
  block.  Limit 1e-5 of the largest gradient entry (gaps read up to 9e-7).
- ``RgLruScanFn`` (the scan's backward as the scan on reversed inputs)
  through ``models/griffin.rg_lru_scan`` against ``jax.grad`` of JAX's
  ``griffin.rg_lru_scan`` (an associative scan, which rounds differently):
  1e-5 of the largest gradient entry; against autograd through the
  sequential recurrence of ``kernels/ref.rg_lru_ref``: 1e-6 of it.
- One AdamW train step (lr 3e-4, weight decay 0.1: ``build_cell``'s
  default) of reduced smollm-135m and reduced recurrentgemma-9b from JAX's
  init.  The first Adam step moves an entry by about lr * sign(g), so an
  entry whose gradient is near 0 may move the other way: the new
  parameters are held to a largest gap in units of lr and each leaf's
  update (new - old) to a relative L2.  float32 compute: loss rtol 1e-6,
  every gradient leaf relative L2 1e-5 (read up to 2.1e-6), updates
  relative L2 5e-3 (read up to 8.4e-4), gap 0.5 lr (read up to 0.15).
  bfloat16 compute: loss rtol 1e-4 (read up to 2.6e-5), gradient leaves
  relative L2 0.06 (read up to 0.034: activations round to bfloat16 at
  every matmul, at other places in the two frameworks), updates relative
  L2 0.6 (read up to 0.35: many small gradients change sign), gap 2.5 lr
  (read up to 2.0: a full flip).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import flash_attention_trainable  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import griffin as jg  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim.sgd import OptimizerConfig as JOptCfg  # noqa: E402
from repro_torch.convert import lm_params_from_tree  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import griffin as tg  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim.sgd import OptimizerConfig as TOptCfg  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

ADAMW = dict(name="adamw", lr=3e-4, weight_decay=0.1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STEP_TOL = {"float32": dict(loss=1e-6, grad=1e-5, delta=5e-3, gap=0.5),
            "bfloat16": dict(loss=1e-4, grad=0.06, delta=0.6, gap=2.5)}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scaled_close(got, want, limit, what):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= limit * scale, (
        what, float(np.abs(got - want).max() / scale))


# ---------------------------------------------------------------------------
# the attention Function
# ---------------------------------------------------------------------------

def _qkv(s, g=2, dh=32, b=1, kv=1, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, kv, g, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, kv, g, dh))]


def _port_attention_grads(q, k, v, w, causal, dtype=torch.float32):
    tq, tk, tv = (torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    return torch.autograd.grad(out, (tq, tk, tv),
                               torch.tensor(w, dtype=dtype))


@pytest.mark.parametrize("s,causal", [(64, True), (64, False), (1024, True)])
def test_attention_grad_matches_jax_trainable(s, causal):
    """Against JAX's custom-VJP attention, its forward the Pallas kernel in
    interpret mode."""
    q, k, v, w = _qkv(s)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(flash_attention_trainable(
        q_, k_, v_, causal, True) * w), argnums=(0, 1, 2))(q, k, v)
    got = _port_attention_grads(q, k, v, w, causal)
    for name, a, b in zip("qkv", got, want):
        _scaled_close(a, b, 1e-5, f"d{name} S={s}")


@pytest.mark.parametrize("s", [1100])
def test_attention_grad_matches_jax_blockwise_ragged(s):
    q, k, v, w = _qkv(s, g=3, kv=2, seed=1)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(jl.flash_attention(
        q_, k_, v_, causal=True, q_block=s, kv_block=s) * w),
        argnums=(0, 1, 2))(q, k, v)
    got = _port_attention_grads(q, k, v, w, True)
    for name, a, b in zip("qkv", got, want):
        _scaled_close(a, b, 1e-5, f"d{name} S={s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_is_autograd_of_the_plain_version(dtype):
    """The Function's backward recomputes the plain blockwise attention and
    differentiates it: equal to autograd straight through
    ``ref.flash_attention_ref``, bit for bit."""
    tdt = DTYPES[dtype][1]
    q, k, v, w = _qkv(1100, seed=2)
    got = _port_attention_grads(q, k, v, w, True, tdt)
    tq, tk, tv = (torch.tensor(x, dtype=tdt, requires_grad=True)
                  for x in (q, k, v))
    out = ref.flash_attention_ref(tq, tk, tv, True)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(w, dtype=tdt))
    for a, b in zip(got, want):
        assert a.dtype == tdt and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the scan Function
# ---------------------------------------------------------------------------

def _xril(t, w=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x, r, i = (rng.standard_normal((b, t, w)).astype(np.float32)
               for _ in range(3))
    lam = rng.uniform(0, 1, w).astype(np.float32)
    wy = rng.standard_normal((b, t, w)).astype(np.float32)
    wh = rng.standard_normal((b, w)).astype(np.float32)
    return x, r, i, lam, wy, wh


def _port_scan_grads(x, r, i, lam, wy, wh):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, r, i, lam)]
    y, h = tg.rg_lru_scan(*ts)
    assert type(y.grad_fn).__name__ == "RgLruScanFnBackward"
    loss = (y * torch.tensor(wy)).sum() + (h * torch.tensor(wh)).sum()
    return torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("t", [1, 2, 7, 64, 129])
def test_scan_grad_matches_jax_associative_scan(t):
    x, r, i, lam, wy, wh = _xril(t, seed=t)

    def loss(x_, r_, i_, lam_):
        y, h = jg.rg_lru_scan(x_, r_, i_, lam_)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, r, i, lam)
    got = _port_scan_grads(x, r, i, lam, wy, wh)
    for name, a, b in zip(("x", "r", "i", "lam"), got, want):
        _scaled_close(a, b, 1e-5, f"d{name} T={t}")


def _sequential(a, b):
    """The recurrence of ``ref.rg_lru_ref`` (one ``addcmul`` a step) with
    no ``out=``, so autograd can run through it."""
    h = torch.zeros(a.shape[0], a.shape[2])
    ys = []
    for t in range(a.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h)
        ys.append(h)
    return torch.stack(ys, 1)


@pytest.mark.parametrize("t", [1, 5, 129])
def test_scan_grad_matches_sequential_autograd(t):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.0, 1.0, (3, t, 8)).astype(np.float32)
    b = rng.standard_normal((3, t, 8)).astype(np.float32)
    w = torch.tensor(rng.standard_normal((3, t, 8)).astype(np.float32))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    y = ops.rg_lru_scan(ta, tb)
    assert torch.equal(y.detach(), ref.rg_lru_ref(ta.detach(), tb.detach()))
    got = torch.autograd.grad((y * w).sum(), (ta, tb))
    sa, sb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    want = torch.autograd.grad((_sequential(sa, sb) * w).sum(), (sa, sb))
    for name, g_, w_ in zip("ab", got, want):
        _scaled_close(g_, w_, 1e-6, f"d{name} T={t}")
    again = torch.autograd.grad((ops.rg_lru_scan(ta, tb) * w).sum(),
                                (ta, tb))
    assert all(torch.equal(x, y_) for x, y_ in zip(got, again))


def test_functions_only_under_grad():
    """The card's route: with an input that requires grad, both ops return
    their Function's output; without one, or under no_grad, the routed call
    itself."""
    q, k, v, _ = _qkv(16)
    q = torch.tensor(q)
    k, v = torch.tensor(k), torch.tensor(v)
    a, b = torch.rand(1, 5, 4), torch.randn(1, 5, 4)
    assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.rg_lru_scan(a, b).grad_fn is None
    for which in range(3):
        qkv = [q, k, v]
        qkv[which] = qkv[which].clone().requires_grad_()
        out = ops.flash_attention(*qkv)
        assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
        with torch.no_grad():
            assert ops.flash_attention(*qkv).grad_fn is None
    for pair in ((a.clone().requires_grad_(), b),
                 (a, b.clone().requires_grad_())):
        assert type(ops.rg_lru_scan(*pair).grad_fn).__name__ == \
            "RgLruScanFnBackward"
        with torch.inference_mode():
            assert ops.rg_lru_scan(*pair).grad_fn is None


# ---------------------------------------------------------------------------
# make_train_step against the JAX package
# ---------------------------------------------------------------------------

def _apis(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    ja, ta = jreg.build(arch, reduced=True), treg.build(arch, reduced=True)
    jcfg = dataclasses.replace(ja.cfg, compute_dtype=jdt)
    tcfg = dataclasses.replace(ta.cfg, compute_dtype=tdt)
    ja = dataclasses.replace(ja, cfg=jcfg, loss_fn=functools.partial(
        ja.loss_fn.func, cfg=jcfg))
    ta = dataclasses.replace(ta, cfg=tcfg, loss_fn=functools.partial(
        ta.loss_fn.func, cfg=tcfg))
    return ja, ta


@functools.lru_cache(maxsize=None)
def _jax_step(arch, dtype):
    ja, _ = _apis(arch, dtype)
    step, opt = jsteps.make_train_step(ja, JOptCfg(**ADAMW))

    def both(p, batch):
        loss, grads = jax.value_and_grad(ja.loss_fn)(p, batch)
        new_p, new_opt, loss2 = step(p, opt.init(p), batch)
        return loss, grads, new_p, new_opt["step"], loss2
    return jax.jit(both)


@pytest.mark.parametrize("arch,seq,dtype", [
    ("smollm-135m", 64, "float32"), ("smollm-135m", 64, "bfloat16"),
    ("smollm-135m", 1100, "float32"),
    ("recurrentgemma-9b", 64, "float32"),
    ("recurrentgemma-9b", 64, "bfloat16")])
def test_adamw_train_step_matches_jax(arch, seq, dtype):
    tol = STEP_TOL[dtype]
    ja, ta = _apis(arch, dtype)
    jp = ja.init(jax.random.PRNGKey(0))
    tp = lm_params_from_tree(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(seq).integers(
        0, ja.cfg.vocab, (2, seq)).astype(np.int32)
    jloss, jgrads, jnew, jstep, jloss2 = _jax_step(arch, dtype)(
        jp, {"tokens": toks})

    step, opt = tsteps.make_train_step(ta, TOptCfg(**ADAMW))
    batch = {"tokens": torch.tensor(toks)}
    loss, grads = tsteps.value_and_grad(ta.loss_fn, tp, batch)
    new_p, new_opt, loss2 = step(tp, opt.init(tp), batch)

    assert float(loss2) == float(loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol["loss"])
    assert int(new_opt["step"]) == int(jstep) == 1
    leaves = zip(jax.tree.leaves(jp), tree_leaves(grads),
                 jax.tree.leaves(jgrads), tree_leaves(new_p),
                 jax.tree.leaves(jnew))
    for i, (p0, g, jgr, p1, jp1) in enumerate(leaves):
        assert g.shape == jgr.shape and p1.dtype == tree_leaves(tp)[i].dtype
        assert np.isfinite(_np(g)).all()
        assert _rel(_np(g), _np(jgr)) <= tol["grad"], (i, _rel(_np(g),
                                                              _np(jgr)))
        # an entry's update is about lr * sign(g): it may flip, no more
        step_gap = np.abs(_np(p1) - _np(jp1)).max() / ADAMW["lr"]
        d = _rel(_np(p1) - _np(p0), _np(jp1) - _np(p0))
        assert step_gap <= tol["gap"] and d <= tol["delta"], (i, step_gap, d)
    # the parameters passed in are left as they were
    assert all(torch.equal(a, torch.tensor(np.asarray(b)))
               for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)))


def _count(monkeypatch, name):
    calls = []
    fn = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("arch,seq", [("smollm-135m", 1100),
                                      ("recurrentgemma-9b", 40)])
def test_remat_recomputes_and_keeps_gradients(arch, seq, monkeypatch):
    """``cfg.remat`` checkpoints each layer (a griffin group; the griffin
    tail's layers run outside): the same loss and gradients, and the
    kernels' forward runs once more per checkpointed layer — the counts
    phase 15 of chip_smoke.py expects of the attention kernel (1 a layer,
    2 with remat) and of the scan (2 a recurrent layer: forward and
    backward; 3 with remat).  Gradients equal within 1e-6 of the largest
    entry (the tied embedding's two contributions add in another order:
    8.9e-8 read; every other leaf is bitwise)."""
    api = treg.build(arch, reduced=True)
    cfg = dataclasses.replace(api.cfg, compute_dtype=torch.float32)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, seq)), dtype=torch.int32)}
    dense = arch == "smollm-135m"
    tail = 0 if dense else cfg.n_layers % 3
    n = cfg.n_layers if dense else 2 * (cfg.n_layers // 3) + tail
    out = {}
    for remat in (False, True):
        calls = _count(monkeypatch, "_flash_forward" if dense
                       else "_rg_forward")
        loss_fn = functools.partial(api.loss_fn.func, cfg=dataclasses.replace(
            cfg, remat=remat))
        out[remat] = tsteps.value_and_grad(loss_fn, params, batch)
        per_layer = 1 if dense else 2
        assert len(calls) == per_layer * n + (n - tail) * remat
        monkeypatch.undo()
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        _scaled_close(a, b, 1e-6, "remat")


def test_prefill_and_decode_steps():
    api = treg.build("smollm-135m", reduced=True)
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 12)), dtype=torch.int32)
    with torch.inference_mode():
        want, cache_w, pos = api.prefill(params, {"tokens": toks}, max_len=16)
        got, cache, pos2 = tsteps.make_prefill_step(api, 16)(
            params, {"tokens": toks})
        assert pos == pos2 and torch.equal(got, want)
        tok = got[:, -1].argmax(-1).to(torch.int32)
        a, _ = tsteps.make_decode_step(api)(params, cache, tok, pos)
        b, _ = api.decode_step(params, cache_w, tok, pos)
        assert torch.equal(a, b)
