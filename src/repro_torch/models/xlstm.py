"""xLSTM (Beck et al., arXiv:2405.04517), sLSTM + mLSTM blocks — the port
of ``repro.models.xlstm``.

* mLSTM: the matrix-memory cell with exponential gating, in the
  chunkwise-parallel form (quadratic within a chunk of ``ch = min(chunk,
  S)`` steps, recurrent state across chunks; a Python loop over the chunks
  where the JAX package scans).  It is the stabilised step recurrence
  exactly: log-sigmoid forget gates in float32, the stabiliser ``m``, the
  lower-triangular mask by ``torch.where`` to -inf, and the denominator
  ``max(|n . q|, exp(-m))``.  A prompt that ``ch`` does not divide raises,
  as the JAX package asserts; nothing is padded.  Decode runs the exact
  one-step recurrence (:func:`mlstm_decode`).
* sLSTM: the scalar cell with a head-block-diagonal recurrence, a Python
  loop over time in plain PyTorch as the JAX package's ``lax.scan``.  No
  TPU kernel lies on this path, and none of the port's kernels runs here.
* Layers come in groups of (7 mLSTM + 1 sLSTM): xlstm-1.3b's 48 layers are
  6 groups.  With ``cfg.remat`` and grad mode on, a full-sequence forward
  runs each group under ``torch.utils.checkpoint`` (non-reentrant), as the
  JAX package wraps its group body in ``jax.checkpoint``.

Parameters keep the JAX package's tree: ``embed.tok``, ``mlstm`` with
every leaf stacked [G, 7, ...] (``norm, w_up, w_gate, w_q, w_k, w_v, w_if,
conv, w_down, out_norm``), ``slstm`` stacked [G, ...] (``norm, w_in, r,
ffn_norm, w_ff_gate, w_ff_up, w_ff_down``), ``final_norm`` and
``unembed``.  States are ``{"mlstm": (C [G, 7, B, H, D, D], n [G, 7, B, H,
D], m [G, 7, B, H], conv_buf [G, 7, B, 4, inner]), "slstm": (h, c, n, m)
each [G, B, d_model]}``, all float32; every entry point returns new state
tensors and leaves the ones passed in as they were.

With ``mp`` (a ``layers.ModelParallel``) every entry point gathers each
leaf the rank holds a block of before using it (a group's leaves as the
group runs, the rest at the entry) and runs the one-process code on the
rank's batch rows; the states hold that batch whole over ``model``.  Under
autograd a gather over ``model`` takes this rank's slice of the gradient
back (every model rank does the same work with the gathered leaf), a gather
over ``data`` (FSDP, the batch split) a reduce-scatter, and the loss is the
mean over the global batch (``layers.softmax_xent``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (LMConfig, constrain_batch, dense_init,
                                       embed_apply, embed_init, rms_norm,
                                       softmax_xent)
from repro_torch.models.transformer import (_unstack, init_stacked,
                                            remat_on, whole)

MLSTM_PER_GROUP = 7
LAYERS_PER_GROUP = MLSTM_PER_GROUP + 1


@dataclasses.dataclass(frozen=True)
class XlstmDims:
    inner: int          # mLSTM expanded dim (2 * d_model)
    n_heads: int
    head_dim: int
    ffn: int            # sLSTM post-FFN dim


def dims(cfg: LMConfig) -> XlstmDims:
    inner = 2 * cfg.d_model
    return XlstmDims(inner=inner, n_heads=cfg.n_heads,
                     head_dim=inner // cfg.n_heads,
                     ffn=int(round(cfg.d_model * 4 / 3 / 128)) * 128)


def n_groups(cfg: LMConfig) -> int:
    g = cfg.n_layers // LAYERS_PER_GROUP
    if g * LAYERS_PER_GROUP != cfg.n_layers:
        raise ValueError(f"xlstm n_layers must be a multiple of "
                         f"{LAYERS_PER_GROUP}, not {cfg.n_layers}")
    return g


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

def init_mlstm_block(gen: torch.Generator, cfg: LMConfig) -> dict:
    d = dims(cfg)
    pd = cfg.param_dtype
    zeros = lambda n: torch.zeros(n, dtype=pd, device=gen.device)
    return {
        "norm": zeros(cfg.d_model),
        "w_up": dense_init(gen, cfg.d_model, d.inner, pd),
        "w_gate": dense_init(gen, cfg.d_model, d.inner, pd),
        "w_q": dense_init(gen, d.inner, d.inner, pd),
        "w_k": dense_init(gen, d.inner, d.inner, pd),
        "w_v": dense_init(gen, d.inner, d.inner, pd),
        "w_if": dense_init(gen, d.inner, 2 * d.n_heads, pd),
        "conv": (torch.randn((4, d.inner), generator=gen, device=gen.device)
                 * 0.1).to(pd),
        "w_down": dense_init(gen, d.inner, cfg.d_model, pd),
        "out_norm": zeros(d.inner),
    }


def _causal_conv4(x, w):
    """Depthwise causal conv, kernel 4.  x [B, S, C], w [4, C]."""
    pads = F.pad(x, (0, 0, 3, 0))
    return sum(pads[:, i:i + x.shape[1], :] * w[i] for i in range(4))


def _chunk_step(C, n, m, qc, kc, vc, igc, lfc):
    """One chunk of the chunkwise mLSTM: qc, kc, vc [B, H, L, D] float32,
    igc, lfc [B, H, L] float32 (input pre-activation, log forget gate);
    C [B, H, D, D], n [B, H, D], m [B, H].  Returns (h [B, H, L, D], C, n,
    m) at the chunk's end."""
    L, D = qc.shape[-2], qc.shape[-1]
    scale = D ** -0.5
    Fc = lfc.cumsum(-1)                    # inclusive cumsum of log f
    # log weight of step s's contribution to step t (s <= t)
    g = Fc[..., :, None] - Fc[..., None, :] + igc[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    g = torch.where(tri, g, float("-inf"))
    m_t = torch.maximum(Fc + m[..., None], g.amax(-1))
    w = torch.exp(g - m_t[..., None])                     # intra weights
    b = torch.exp(Fc + m[..., None] - m_t)                # inter scale
    qk = qc @ kc.transpose(-1, -2) * scale
    num = (w * qk) @ vc + ((qc * scale) @ C) * b[..., None]
    n_dot_q = ((w @ kc) * qc).sum(-1) * scale \
        + b * (qc @ n[..., None])[..., 0] * scale
    den = torch.maximum(n_dot_q.abs(), torch.exp(-m_t))
    h = num / den[..., None]

    FL = Fc[..., -1]                                      # [B, H]
    g_end = FL[..., None] - Fc + igc
    m_end = torch.maximum(FL + m, g_end.amax(-1))
    w_end = torch.exp(g_end - m_end[..., None])
    decay = torch.exp(FL + m - m_end)
    kw = kc * w_end[..., None]
    C = C * decay[..., None, None] + kw.transpose(-1, -2) @ vc
    n = n * decay[..., None] + kw.sum(-2)
    return h, C, n, m_end


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk: int):
    """Chunkwise-parallel mLSTM over q, k, v [B, S, H, D] and the gates'
    pre-activations i_pre, f_pre [B, S, H]; ``state`` (C [B, H, D, D], n
    [B, H, D], m [B, H]).  Returns (h [B, S, H, D] float32, new state).
    ``chunk`` must divide S."""
    B, S, H, D = q.shape
    if S % chunk:
        raise ValueError(f"the mLSTM chunk {chunk} does not divide the "
                         f"sequence length {S}")
    nc = S // chunk

    def split(x):                           # [B, S, H, ...] -> chunks
        x = x.float().reshape(B, nc, chunk, H, *x.shape[3:])
        return x.transpose(2, 3).unbind(1)  # nc x [B, H, L, ...]
    qs, ks, vs, igs = split(q), split(k), split(v), split(i_pre)
    lfs = split(F.logsigmoid(f_pre.float()))
    C, n, m = state
    hs = []
    for c in range(nc):
        h, C, n, m = _chunk_step(C, n, m, qs[c], ks[c], vs[c], igs[c],
                                 lfs[c])
        hs.append(h)
    h = torch.stack(hs, 1)                  # [B, nc, H, L, D]
    return h.transpose(2, 3).reshape(B, S, H, D), (C, n, m)


def mlstm_decode(q, k, v, i_pre, f_pre, state):
    """Exact single-step recurrence.  q, k, v [B, H, D]; gates [B, H]."""
    C, n, m = state
    q, k, v = q.float(), k.float(), v.float()
    lf = F.logsigmoid(f_pre.float())
    ig = i_pre.float()
    m_new = torch.maximum(lf + m, ig)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(ig - m_new)
    C = C * fp[..., None, None] \
        + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * fp[..., None] + ip[..., None] * k
    scale = q.shape[-1] ** -0.5
    num = (q[..., None, :] @ C)[..., 0, :] * scale
    den = torch.maximum((n * q).sum(-1).abs() * scale, torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def mlstm_block_apply(p: dict, x: torch.Tensor, cfg: LMConfig, state,
                      chunk: int = 256, decode: bool = False):
    """Pre-up-projection mLSTM block.  x [B, S, Dm] (S = 1 when decode);
    ``state`` (C, n, m, conv_buf): the matrix memory and the causal conv's
    buffer of the last 4 ``up`` activations (float32), so decode matches
    the full-sequence path.  Returns (x + out, new state)."""
    d = dims(cfg)
    cdt = cfg.compute_dtype
    B, S, _ = x.shape
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    up = y @ p["w_up"].to(cdt)
    gate = y @ p["w_gate"].to(cdt)
    C0, n0, m0, conv_buf = state
    if decode:
        conv_buf = torch.cat([conv_buf[:, 1:], up.float()], dim=1)
        # the conv in the compute dtype, as the full-sequence path computes
        # it: a float32 decode conv against a bf16 prefill conv drifts ~0.1
        # in the logits once the exponential gates amplify it
        c = torch.einsum("btc,tc->bc", conv_buf.to(cdt),
                         p["conv"].to(cdt))[:, None]
    else:
        c = _causal_conv4(up, p["conv"].to(cdt))
        tail = up[:, -4:].float()
        pad = up.new_zeros((B, max(0, 4 - S), up.shape[-1]),
                           dtype=torch.float32)
        conv_buf = torch.cat([conv_buf[:, S:], pad, tail], dim=1)[:, -4:]
    c = F.silu(c)
    heads = (B, S, d.n_heads, d.head_dim)
    q = (c @ p["w_q"].to(cdt)).view(heads)
    k = (c @ p["w_k"].to(cdt)).view(heads)
    v = (up @ p["w_v"].to(cdt)).view(heads)
    gates = (c @ p["w_if"].to(cdt)).view(B, S, 2, d.n_heads)
    i_pre, f_pre = gates[:, :, 0], gates[:, :, 1]
    if decode:
        h, cell = mlstm_decode(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                               f_pre[:, 0], (C0, n0, m0))
        h = h[:, None]
    else:
        h, cell = mlstm_chunkwise(q, k, v, i_pre, f_pre, (C0, n0, m0),
                                  min(chunk, S))
    h = rms_norm(h.reshape(B, S, d.inner).to(cdt), p["out_norm"],
                 cfg.norm_eps)
    out = (h * F.silu(gate)) @ p["w_down"].to(cdt)
    return x + out, cell + (conv_buf,)


# ---------------------------------------------------------------------------
# sLSTM cell (scalar, sequential)
# ---------------------------------------------------------------------------

def init_slstm_block(gen: torch.Generator, cfg: LMConfig) -> dict:
    d = dims(cfg)
    pd = cfg.param_dtype
    hd = cfg.d_model // cfg.n_heads
    zeros = lambda: torch.zeros(cfg.d_model, dtype=pd, device=gen.device)
    return {
        "norm": zeros(),
        "w_in": dense_init(gen, cfg.d_model, 4 * cfg.d_model, pd),
        "r": (torch.randn((cfg.n_heads, 4, hd, hd), generator=gen,
                          device=gen.device) / hd ** 0.5).to(pd),
        "ffn_norm": zeros(),
        "w_ff_gate": dense_init(gen, cfg.d_model, d.ffn, pd),
        "w_ff_up": dense_init(gen, cfg.d_model, d.ffn, pd),
        "w_ff_down": dense_init(gen, d.ffn, cfg.d_model, pd),
    }


def _recurrent_weight(r: torch.Tensor) -> torch.Tensor:
    """r [H, 4, hd, hd] -> [H, hd, 4 * hd] float32: one matmul a head."""
    H, _, hd, _ = r.shape
    return r.float().permute(0, 2, 1, 3).reshape(H, hd, 4 * hd)


def slstm_step(r_w: torch.Tensor, xt: torch.Tensor, state):
    """One sLSTM step.  ``r_w`` the recurrent weight from
    :func:`_recurrent_weight`; xt [B, 4 * Dm] pre-activations (z, i, f, o);
    state (h, c, n, m) [B, Dm] float32."""
    h, c, n, m = state
    B = xt.shape[0]
    H, hd = r_w.shape[0], r_w.shape[1]
    rec = torch.bmm(h.view(B, H, hd).transpose(0, 1), r_w)  # [H, B, 4 hd]
    rec = rec.view(H, B, 4, hd).permute(1, 2, 0, 3)          # [B, 4, H, hd]
    pre = (xt.float().view(B, 4, H, hd) + rec).reshape(B, 4, H * hd)
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre = pre[:, 1], pre[:, 2]
    o = torch.sigmoid(pre[:, 3])
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + m, i_pre)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(i_pre - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / n_new.clamp_min(1e-6)
    return h_new, c_new, n_new, m_new


def slstm_block_apply(p: dict, x: torch.Tensor, cfg: LMConfig, state,
                      decode: bool = False):
    """x [B, S, Dm]: the recurrence one step at a time (the sLSTM has a
    true recurrence), then the block's gated FFN.  Returns (x, state)."""
    cdt = cfg.compute_dtype
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    pre = y @ p["w_in"].to(cdt)                    # [B, S, 4 Dm]
    r_w = _recurrent_weight(p["r"])
    hs = []
    for t in range(pre.shape[1]):
        state = slstm_step(r_w, pre[:, t], state)
        hs.append(state[0])
    x = x + torch.stack(hs, 1).to(cdt)
    y = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    f = F.silu(y @ p["w_ff_gate"].to(cdt)) * (y @ p["w_ff_up"].to(cdt))
    return x + f @ p["w_ff_down"].to(cdt), state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: LMConfig, keep=whole) -> dict:
    """Random parameters drawn from ``generator``, on its device; each
    group's blocks are copied into the stacked leaves as they are drawn,
    each through ``keep`` (``transformer.init``)."""
    G = n_groups(cfg)
    return {
        "embed": keep("embed", {"tok": embed_init(
            generator, cfg.vocab, cfg.d_model, cfg.param_dtype)}),
        "mlstm": init_stacked(lambda: init_stacked(
            lambda: keep("mlstm", init_mlstm_block(generator, cfg), 2),
            MLSTM_PER_GROUP), G),
        "slstm": init_stacked(
            lambda: keep("slstm", init_slstm_block(generator, cfg), 1), G),
        "final_norm": keep("final_norm", torch.zeros(
            cfg.d_model, dtype=cfg.param_dtype, device=generator.device)),
        "unembed": keep("unembed", dense_init(
            generator, cfg.d_model, cfg.vocab, cfg.param_dtype)),
    }


def init_states(cfg: LMConfig, batch: int, device=None) -> dict:
    """Zero states (float32), in the layout of the module docstring."""
    d = dims(cfg)
    G, B = n_groups(cfg), batch
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    lead = (G, MLSTM_PER_GROUP, B, d.n_heads)
    return {"mlstm": (z(*lead, d.head_dim, d.head_dim), z(*lead, d.head_dim),
                      z(*lead), z(G, MLSTM_PER_GROUP, B, 4, d.inner)),
            "slstm": tuple(z(G, B, cfg.d_model) for _ in range(4))}


def _group_apply(blocks: list, sp: dict, mstate: list, sstate: tuple,
                 x: torch.Tensor, cfg: LMConfig, chunk: int, decode: bool):
    """One group: 7 mLSTM blocks, then the sLSTM block.  Returns (x, the 7
    new mLSTM states, the new sLSTM state)."""
    new = []
    for p, st in zip(blocks, mstate):
        x, st = mlstm_block_apply(p, x, cfg, st, chunk=chunk, decode=decode)
        new.append(st)
    x, sstate = slstm_block_apply(sp, x, cfg, sstate, decode=decode)
    return x, new, sstate


def _stack_forward(params: dict, x: torch.Tensor, cfg: LMConfig, states,
                   decode: bool = False, mp=None):
    """The groups in order; returns (x, new states)."""
    G = n_groups(cfg)
    remat = remat_on(cfg) and not decode
    m_new = tuple(torch.empty_like(t) for t in states["mlstm"])
    s_new = tuple(torch.empty_like(t) for t in states["slstm"])
    m_groups = _unstack(params["mlstm"], G)
    s_groups = _unstack(params["slstm"], G)
    for g in range(G):
        mg, sg = m_groups[g], s_groups[g]
        if mp is not None:
            mg = mp.sub("mlstm").layer().gather_tree(mg)
            sg = mp.sub("slstm").layer().gather_tree(sg)
        blocks = _unstack(mg, MLSTM_PER_GROUP)
        mstate = list(zip(*(t[g] for t in states["mlstm"])))
        sstate = tuple(t[g] for t in states["slstm"])
        args = (blocks, sg, mstate, sstate, x, cfg, cfg.mlstm_chunk, decode)
        if remat:
            x, new, ns = checkpoint(_group_apply, *args, use_reentrant=False)
        else:
            x, new, ns = _group_apply(*args)
        x = constrain_batch(x, mp)
        for j, st in enumerate(new):
            for dst, src in zip(m_new, st):
                dst[g, j] = src
        for dst, src in zip(s_new, ns):
            dst[g] = src
    return x, {"mlstm": m_new, "slstm": s_new}


def _gathered(params: dict, mp) -> dict:
    """The parameters with every leaf outside the stacked ``mlstm`` and
    ``slstm`` groups gathered whole (``mp`` None: ``params`` itself)."""
    if mp is None:
        return params
    return {k: v if k in ("mlstm", "slstm") else mp.sub(k).gather_tree(v)
            for k, v in params.items()}


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"].to(cfg.compute_dtype)


def forward(params: dict, batch: dict, cfg: LMConfig, mp=None):
    """Full-sequence forward from zero states: (logits [B, S, V], aux = 0),
    the formulation of the JAX package's ``loss_fn``."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    x, _ = _stack_forward(params, x, cfg,
                          init_states(cfg, x.shape[0], x.device), mp=mp)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            mp=None) -> torch.Tensor:
    """Next-token cross-entropy of :func:`forward`."""
    logits, _ = forward(params, batch, cfg, mp)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], mp=mp)


def prefill(params: dict, batch: dict, cfg: LMConfig,
            max_len: int | None = None, mp=None):
    """Runs the prompt and builds the states; returns (last_logits [B, 1,
    V], states, pos = S).  ``max_len`` is accepted for the registry's
    signature: the states do not grow with the sequence."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    x, states = _stack_forward(params, x, cfg, init_states(cfg, b, x.device),
                               mp=mp)
    return _logits(params, x[:, -1:], cfg), states, s


def decode_step(params: dict, states: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig, mp=None):
    """One decode step: tokens [B] -> (logits [B, 1, V], new states);
    ``pos`` is accepted for the registry's signature."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    x, states = _stack_forward(params, x, cfg, states, decode=True, mp=mp)
    return _logits(params, x, cfg), states
