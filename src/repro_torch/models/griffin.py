"""Griffin / RecurrentGemma (De et al., arXiv:2402.19427) — the port of
``repro.models.griffin``.

Residual pattern (recurrent, recurrent, local-attention) repeating:
recurrentgemma-9b's 38 layers are 12 full groups and a 2-layer recurrent
tail.  Every layer is a mixer (RG-LRU recurrent block or local MQA)
followed by a gated-GeLU MLP block, both pre-RMSNorm.

Parameters keep the JAX package's tree: ``embed.tok`` (tied unembedding),
``groups`` with every leaf stacked on a leading [G] axis (``rec0``,
``mlp0``, ``rec1``, ``mlp1``, ``attn``, ``mlp2``), ``tail_rec{t}`` /
``tail_mlp{t}`` and ``final_norm``.  ``_stack_forward`` is a Python loop
over the G groups and then the tail, where the JAX package scans; with
``cfg.remat`` and grad mode on, a full-sequence forward runs each group
under ``torch.utils.checkpoint`` (non-reentrant), as the JAX package
wraps its group body in ``jax.checkpoint``.

Routes.  The RG-LRU scan of a full sequence builds (a, b) in float32 and
sends the recurrence h_t = a_t * h_{t-1} + b_t to
``kernels/ops.rg_lru_scan``: the CUDA kernel on the card, its plain
sequential loop on the CPU; under autograd its backward is the same scan
on time-reversed inputs (``ops.RgLruScanFn``).  The JAX package computes
the same recurrence with ``lax.associative_scan``, a tree, so float32
results differ by rounding.  Local attention (window ``sliding_window``; d_head 256 at full
width) runs the plain blockwise ``layers.flash_attention`` with its window
mask at S >= 1024 and einsum + softmax below: that is the JAX package's own
split, whose griffin calls its jnp ``layers.flash_attention`` and never the
Pallas attention kernel (which takes no window and no d_head 256), so the
port's attention kernel is not on this path either.

Decode carries (h, conv_buf) per recurrent layer and a ring KV cache of
``sliding_window`` slots per attention layer (slot ``pos % window`` holds
position ``pos``).  The ring caches are written in place (the JAX functions
return updated copies) and returned; the recurrent states are returned as
new tensors.

With ``mp`` (a ``layers.ModelParallel``) every entry point gathers each
leaf the rank holds a block of before using it (the group's leaves as each
group runs, the rest at the entry), as GSPMD would reshard them, and runs
the one-process code on the rank's batch rows; the states hold that batch
whole over ``model`` (``cache_specs`` splits their last dim, which this
route does not consume).  Under autograd a gather over ``model`` takes this
rank's slice of the gradient back (every model rank does the same work with
the gathered leaf), a gather over ``data`` (FSDP, the batch split) a
reduce-scatter, and the loss is the mean over the global batch
(``layers.softmax_xent``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_LOGIT
from repro_torch.models.layers import (LMConfig, _flash_ok, apply_rope,
                                       constrain_batch, dense_init,
                                       embed_apply, embed_init,
                                       flash_attention, rms_norm,
                                       softmax_xent)
from repro_torch.models.transformer import (_unstack, init_stacked,
                                            remat_on, whole)

GROUP = ("rec", "rec", "attn")
C_SCALE = 8.0          # the paper's c constant


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")         # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rg_lru_scan(x, r, i, lam):
    """x, r, i: [B, S, W]; lam: [W].  Returns (y [B, S, W], h_last [B, W]),
    float32; h_last is a copy, so a state does not hold y's memory."""
    log_a = -C_SCALE * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i.float()) * x.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    y = ops.rg_lru_scan(a, b)
    return y, y[:, -1].clone()


def rg_lru_step(x, r, i, lam, h):
    """One token: x, r, i, h [B, W].  ``a * h + b`` is rounded once
    (``addcmul``), as XLA contracts it."""
    log_a = -C_SCALE * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * torch.sigmoid(i.float()) * x.float()
    h = torch.addcmul(b, a, h)
    return h, h


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _zeros(cfg: LMConfig, n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.zeros(n, dtype=cfg.param_dtype, device=gen.device)


def init_recurrent_block(gen: torch.Generator, cfg: LMConfig) -> dict:
    w = cfg.lru_width or cfg.d_model
    pd = cfg.param_dtype
    return {
        "norm": _zeros(cfg, cfg.d_model, gen),
        "w_x": dense_init(gen, cfg.d_model, w, pd),
        "w_gate": dense_init(gen, cfg.d_model, w, pd),
        "conv": (torch.randn((4, w), generator=gen, device=gen.device)
                 * 0.1).to(pd),
        "w_r": dense_init(gen, w, w, pd),
        "w_i": dense_init(gen, w, w, pd),
        "lam": torch.rand((w,), generator=gen, dtype=torch.float32,
                          device=gen.device),
        "w_out": dense_init(gen, w, cfg.d_model, pd),
    }


def _causal_conv4(x, w):
    pads = F.pad(x, (0, 0, 3, 0))
    return sum(pads[:, i:i + x.shape[1], :] * w[i] for i in range(4))


def recurrent_block_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
                          state=None, decode: bool = False):
    """state = (h [B, W], conv_buf [B, 4, W]) or None."""
    cdt = cfg.compute_dtype
    b, s, _ = x.shape
    w = cfg.lru_width or cfg.d_model
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    xb = y @ p["w_x"].to(cdt)
    gate = _gelu(y @ p["w_gate"].to(cdt))
    if state is None:
        state = (torch.zeros((b, w), dtype=torch.float32, device=x.device),
                 torch.zeros((b, 4, w), dtype=torch.float32,
                             device=x.device))
    h0, conv_buf = state
    if decode:
        conv_buf = torch.cat([conv_buf[:, 1:], xb.float()], dim=1)
        c = torch.einsum("btc,tc->bc", conv_buf.to(cdt),
                         p["conv"].to(cdt)).float()
        r = c @ p["w_r"].float()
        i = c @ p["w_i"].float()
        h, yout = rg_lru_step(c, r, i, p["lam"], h0)
        yout = yout[:, None]
    else:
        c = _causal_conv4(xb, p["conv"].to(cdt)).float()
        r = c @ p["w_r"].float()
        i = c @ p["w_i"].float()
        yout, h = rg_lru_scan(c, r, i, p["lam"])
        tail = xb[:, -4:].float()
        pad = torch.zeros((b, max(0, 4 - s), w), dtype=torch.float32,
                          device=x.device)
        conv_buf = torch.cat([conv_buf[:, s:], pad, tail], dim=1)[:, -4:]
    out = (yout.to(cdt) * gate) @ p["w_out"].to(cdt)
    return x + out, (h, conv_buf)


def init_attn_block(gen: torch.Generator, cfg: LMConfig) -> dict:
    dh = cfg.head_dim
    pd = cfg.param_dtype
    return {
        "norm": _zeros(cfg, cfg.d_model, gen),
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, pd),
        "wkv": dense_init(gen, cfg.d_model, 2 * cfg.n_kv_heads * dh, pd),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, pd),
    }


def attn_block_apply(p: dict, x: torch.Tensor, cfg: LMConfig, positions,
                     cache=None, cache_pos=None, decode: bool = False):
    """Local (sliding-window) MQA.  ``cache`` is a ring buffer {k, v [B,
    Wnd, KV, dh]}: decode writes slot ``cache_pos % Wnd`` (``cache_pos``
    an int, the absolute position) in place and attends over the valid
    slots; a prefill (``cache`` given, not decode) attends with a [S, S]
    window mask and writes the last min(Wnd, S) keys and values in place,
    slot (pos % Wnd) holding position pos."""
    cdt = cfg.compute_dtype
    b, s, _ = x.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wnd = cfg.sliding_window
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (y @ p["wq"].to(cdt)).view(b, s, h, dh)
    kvp = (y @ p["wkv"].to(cdt)).view(b, s, 2, kv, dh)
    k, v = kvp[:, :, 0], kvp[:, :, 1]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, s, kv, h // kv, dh)

    if decode:
        slot = cache_pos % wnd
        cache["k"][:, slot:slot + s] = k
        cache["v"][:, slot:slot + s] = v
        ck, cv = cache["k"], cache["v"]
        kpos = cache_pos - torch.remainder(
            slot - torch.arange(wnd, device=x.device), wnd)
        valid = (kpos >= 0) & (kpos > cache_pos - wnd)
        logits = torch.einsum("bskgd,btkd->bkgst", q, ck).float() \
            * dh ** -0.5
        logits = torch.where(valid, logits, NEG_LOGIT)
        attn = torch.softmax(logits, dim=-1).to(cdt)
        o = torch.einsum("bkgst,btkd->bskgd", attn, cv).reshape(b, s, h * dh)
    else:
        if _flash_ok(s, s):
            o = flash_attention(q, k, v, causal=True, window=wnd)
            o = o.reshape(b, s, h * dh).to(cdt)
        else:
            logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() \
                * dh ** -0.5
            qp = positions if positions.dim() == 1 else positions[0]
            mask = (qp[:, None] >= qp[None, :]) & \
                (qp[:, None] - qp[None, :] < wnd)
            logits = torch.where(mask, logits, NEG_LOGIT)
            attn = torch.softmax(logits, dim=-1).to(cdt)
            o = torch.einsum("bkgst,btkd->bskgd", attn, v).reshape(
                b, s, h * dh)
        if cache is not None:
            last = min(wnd, s)
            slots = torch.remainder(
                s - last + torch.arange(last, device=x.device), wnd)
            for name, t in (("k", k), ("v", v)):
                cache[name].zero_()
                cache[name][:, slots] = t[:, -last:]
    return x + o @ p["wo"].to(cdt), cache


def init_mlp_block(gen: torch.Generator, cfg: LMConfig) -> dict:
    pd = cfg.param_dtype
    return {
        "norm": _zeros(cfg, cfg.d_model, gen),
        "w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, pd),
        "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, pd),
        "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, pd),
    }


def mlp_block_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    f = _gelu(y @ p["w_gate"].to(cdt)) * (y @ p["w_up"].to(cdt))
    return x + f @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# full model: a loop over (rec, rec, attn) groups + recurrent tail
# ---------------------------------------------------------------------------

def _layout(cfg: LMConfig) -> tuple[int, int]:
    """(n_full_groups, n_tail_recurrent)."""
    n_groups = cfg.n_layers // len(GROUP)
    tail = cfg.n_layers - n_groups * len(GROUP)
    assert tail in (0, 1, 2), cfg.n_layers
    return n_groups, tail


def _init_group(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {"rec0": init_recurrent_block(gen, cfg),
            "mlp0": init_mlp_block(gen, cfg),
            "rec1": init_recurrent_block(gen, cfg),
            "mlp1": init_mlp_block(gen, cfg),
            "attn": init_attn_block(gen, cfg),
            "mlp2": init_mlp_block(gen, cfg)}


def init(generator: torch.Generator, cfg: LMConfig, keep=whole) -> dict:
    """Random parameters drawn from ``generator``, on its device.  Each
    group is drawn and copied into the stacked [G] leaves at once, so at
    most one group's parameters exist twice; each subtree goes through
    ``keep`` as it is drawn (``transformer.init``)."""
    G, tail = _layout(cfg)
    p = {"embed": keep("embed", {"tok": embed_init(
             generator, cfg.vocab, cfg.d_model, cfg.param_dtype)}),
         "groups": init_stacked(
             lambda: keep("groups", _init_group(generator, cfg), 1), G),
         "final_norm": keep("final_norm", _zeros(cfg, cfg.d_model,
                                                 generator))}
    for t in range(tail):
        p[f"tail_rec{t}"] = keep(f"tail_rec{t}",
                                 init_recurrent_block(generator, cfg))
        p[f"tail_mlp{t}"] = keep(f"tail_mlp{t}",
                                 init_mlp_block(generator, cfg))
    return p


def init_states(cfg: LMConfig, batch: int, device=None) -> dict:
    """Zero decode states: (h [G, B, W], conv_buf [G, B, 4, W]) float32 for
    ``rec0``/``rec1`` (unstacked for each ``tail_rec{t}``), and the ring
    caches ``attn.{k, v}`` [G, B, Wnd, KV, dh] in ``compute_dtype``."""
    G, tail = _layout(cfg)
    w = cfg.lru_width or cfg.d_model

    def rec(*lead):
        return (torch.zeros(lead + (batch, w), dtype=torch.float32,
                            device=device),
                torch.zeros(lead + (batch, 4, w), dtype=torch.float32,
                            device=device))

    kv_shape = (G, batch, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim)
    st = {"rec0": rec(G), "rec1": rec(G),
          "attn": {n: torch.zeros(kv_shape, dtype=cfg.compute_dtype,
                                  device=device) for n in ("k", "v")}}
    for t in range(tail):
        st[f"tail_rec{t}"] = rec()
    return st


def _group_apply(gp: dict, x: torch.Tensor, st0, st1, cache, positions,
                 cfg: LMConfig, cache_pos=None, decode: bool = False):
    """One (rec, mlp, rec, mlp, attn, mlp) group: (x, new rec0 state, new
    rec1 state)."""
    x, ns0 = recurrent_block_apply(gp["rec0"], x, cfg, state=st0,
                                   decode=decode)
    x = mlp_block_apply(gp["mlp0"], x, cfg)
    x, ns1 = recurrent_block_apply(gp["rec1"], x, cfg, state=st1,
                                   decode=decode)
    x = mlp_block_apply(gp["mlp1"], x, cfg)
    x, _ = attn_block_apply(gp["attn"], x, cfg, positions, cache=cache,
                            cache_pos=cache_pos, decode=decode)
    return mlp_block_apply(gp["mlp2"], x, cfg), ns0, ns1


def _gathered(params: dict, mp) -> dict:
    """The parameters with every leaf outside the stacked ``groups``
    gathered whole (``mp`` None: ``params`` itself); the groups are
    gathered one at a time by :func:`_stack_forward`."""
    if mp is None:
        return params
    return {k: v if k == "groups" else mp.sub(k).gather_tree(v)
            for k, v in params.items()}


def _stack_forward(params: dict, x: torch.Tensor, cfg: LMConfig,
                   states: dict, positions, cache_pos=None,
                   decode: bool = False, want_cache: bool = False, mp=None):
    """The layer stack; returns (x, new_states).  The ring caches of
    ``states`` are written in place when ``decode`` or ``want_cache``."""
    G, tail = _layout(cfg)
    rec_new = {name: tuple(torch.empty_like(t) for t in states[name])
               for name in ("rec0", "rec1")}
    remat = remat_on(cfg) and not (decode or want_cache)
    mpg = None if mp is None else mp.sub("groups").layer()
    for g, gp in enumerate(_unstack(params["groups"], G)):
        if mpg is not None:
            gp = mpg.gather_tree(gp)
        cache = ({n: t[g] for n, t in states["attn"].items()}
                 if decode or want_cache else None)
        args = (gp, x, tuple(t[g] for t in states["rec0"]),
                tuple(t[g] for t in states["rec1"]), cache, positions, cfg,
                cache_pos, decode)
        if remat:
            x, ns0, ns1 = checkpoint(_group_apply, *args,
                                     use_reentrant=False)
        else:
            x, ns0, ns1 = _group_apply(*args)
        x = constrain_batch(x, mp)
        for name, ns in (("rec0", ns0), ("rec1", ns1)):
            for dst, src in zip(rec_new[name], ns):
                dst[g] = src
    new_states = {**rec_new, "attn": states["attn"]}
    for t in range(tail):
        x, ns = recurrent_block_apply(params[f"tail_rec{t}"], x, cfg,
                                      state=states[f"tail_rec{t}"],
                                      decode=decode)
        x = mlp_block_apply(params[f"tail_mlp{t}"], x, cfg)
        new_states[f"tail_rec{t}"] = ns
    return x, new_states


def _unembed(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"]["tok"].to(cfg.compute_dtype).T


def forward(params: dict, batch: dict, cfg: LMConfig, mp=None):
    """Full-sequence forward from zero states: (logits [B, S, V], aux = 0),
    the formulation of the JAX package's ``loss_fn``."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    x, _ = _stack_forward(params, x, cfg, init_states(cfg, b, x.device),
                          torch.arange(s, device=x.device), mp=mp)
    return _unembed(params, x, cfg), torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            mp=None) -> torch.Tensor:
    """Next-token cross-entropy of :func:`forward`."""
    logits, _ = forward(params, batch, cfg, mp)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], mp=mp)


def prefill(params: dict, batch: dict, cfg: LMConfig,
            max_len: int | None = None, mp=None):
    """Runs the prompt and builds the decode states; returns (last_logits
    [B, 1, V], states, pos = S).  ``max_len`` is accepted for the
    registry's signature: the states do not grow with the sequence."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    x, states = _stack_forward(params, x, cfg,
                               init_states(cfg, b, x.device),
                               torch.arange(s, device=x.device),
                               want_cache=True, mp=mp)
    return _unembed(params, x[:, -1:], cfg), states, s


def decode_step(params: dict, states: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig, mp=None):
    """One decode step: tokens [B] at absolute position ``pos`` (an int) ->
    (logits [B, 1, V], states); the ring caches are written in place."""
    params = _gathered(params, mp)
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    x, states = _stack_forward(params, x, cfg, states, positions,
                               cache_pos=pos, decode=True, mp=mp)
    return _unembed(params, x, cfg), states
