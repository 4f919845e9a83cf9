"""Decoder-only transformer, the dense, moe and vlm families — the port
of ``repro.models.transformer``.

Parameters are the JAX package's tree as a nested dict of tensors, the
per-layer ones stacked on a leading [L] axis (``layers.attn.wq`` is
[L, d_model, H * dh]; a moe layer has ``layers.moe.{router, w_gate, w_up,
w_down[, shared]}`` where a dense one has ``layers.mlp``; a vlm adds
``patch_proj`` [patch_embed_dim, d_model]); the layer stack is a Python
loop over that axis where the JAX package scans.  Entry points:

  * ``forward(params, batch, cfg)`` and ``loss_fn`` — the full sequence,
    differentiable (``launch/steps.make_train_step`` trains through it);
    with ``cfg.remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps
    its scanned layer in ``jax.checkpoint``;
  * ``prefill(params, batch, cfg, max_len)`` — builds the KV cache;
  * ``decode_step(params, cache, tokens, pos, cfg)`` — one token.

A vlm batch carries ``patch_embeds`` [B, n_patches, patch_embed_dim]
beside ``tokens``: the projected patches come before the text, so a
prefill's ``pos`` counts them and decode goes on at n_patches + text.
``forward`` returns the MoE auxiliary loss summed over the layers (0 for
the other families), and ``loss_fn`` adds it to the cross-entropy of the
text positions.

The KV cache is ``{"k", "v"}`` of [L, B, max_len, KV, dh] in
``compute_dtype``; ``decode_step`` writes it in place (the JAX function
returns an updated copy) and returns it.

Every entry point takes ``mp``, a ``layers.ModelParallel`` for one rank of
a device mesh (None: one process, the code above operation for operation).
With it the parameters are the rank's blocks, the batch its B / n_data
rows, the logits whole over the vocab, and the cache its slice: [L, B /
n_data, max_len / P, KV, dh] (models/layers.py says how each leaf is
used).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding
from repro_torch.models.layers import (LMConfig, _sub, attention_apply,
                                       constrain_batch, embed_apply,
                                       init_attention, init_embed,
                                       init_kv_cache, init_mlp, init_moe,
                                       mlp_apply, moe_apply, rms_norm,
                                       softmax_xent, unembed_apply)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    zeros = lambda: torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                device=gen.device)
    p = {"attn_norm": zeros(), "mlp_norm": zeros(),
         "attn": init_attention(gen, cfg)}
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _empty_stacked(tree: dict, n: int) -> dict:
    return {k: (_empty_stacked(v, n) if isinstance(v, dict)
                else v.new_empty((n,) + v.shape)) for k, v in tree.items()}


def _put(dst: dict, src: dict, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst[k], v, i)
        else:
            dst[k][i] = v


def init_stacked(make, n: int) -> dict:
    """``n`` trees from ``make()``, drawn in order and stacked on a leading
    [n] axis: each is copied into preallocated leaves as soon as it is
    drawn, so at most one draw's parameters exist twice (a full-width
    stack fits where its double would not)."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            out = _empty_stacked(one, n)
        _put(out, one, i)
        del one
    return out


def whole(_path, tree, lead: int = 0):
    """The ``keep`` of one process: every drawn subtree kept whole."""
    return tree


def init(generator: torch.Generator, cfg: LMConfig, keep=whole) -> dict:
    """Random parameters drawn from ``generator``, on its device.  Each
    subtree goes through ``keep(path, tree, lead)`` as it is drawn, a layer
    with ``lead`` 1 (``distributed/sharding.block_keeper``: a rank keeps
    its blocks, so the whole model never exists at once); the draws are
    the same whatever ``keep`` does."""
    p = {"embed": keep("embed", init_embed(generator, cfg)),
         "layers": init_stacked(
             lambda: keep("layers", _init_layer(generator, cfg), 1),
             cfg.n_layers),
         "final_norm": keep("final_norm", torch.zeros(
             cfg.d_model, dtype=cfg.param_dtype, device=generator.device))}
    if cfg.family == "vlm":
        p["patch_proj"] = keep("patch_proj", (torch.randn(
            (cfg.patch_embed_dim, cfg.d_model), generator=generator,
            device=generator.device) * cfg.patch_embed_dim ** -0.5
        ).to(cfg.param_dtype))
    return p


def _layer(params: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in params.items()}


def _unstack(params: dict, n: int) -> list[dict]:
    """The n per-layer dicts of [n]-stacked leaves, by ``torch.unbind``:
    views whose gradients autograd stacks once, not n full-size sums."""
    out = [{} for _ in range(n)]
    for k, v in params.items():
        parts = (_unstack(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for d, part in zip(out, parts):
            d[k] = part
    return out


def remat_on(cfg) -> bool:
    """Whether a forward recomputes its layers in the backward pass:
    ``cfg.remat`` with grad mode on (inference never checkpoints)."""
    return cfg.remat and torch.is_grad_enabled()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block(pl: dict, x: torch.Tensor, cfg: LMConfig, positions,
           kv_cache=None, cache_pos=None, mp=None):
    """One transformer block.  Returns (x, kv_cache, aux): the MoE layer's
    auxiliary loss, or 0.0 with a dense MLP."""
    h, kv_cache = attention_apply(
        pl["attn"], rms_norm(x, pl["attn_norm"], cfg.norm_eps), cfg,
        positions, kv_cache=kv_cache, cache_pos=cache_pos,
        window=cfg.sliding_window, mp=_sub(mp, "attn"))
    x = x + h
    y = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = moe_apply(pl["moe"], y, cfg, mp=_sub(mp, "moe"))
    else:
        m, aux = mlp_apply(pl["mlp"], y, cfg, mp=_sub(mp, "mlp")), 0.0
    return constrain_batch(x + m, mp), kv_cache, aux


def _embed_inputs(params: dict, batch: dict, cfg: LMConfig,
                  mp=None) -> torch.Tensor:
    """tokens [B, S] (and a vlm's patch_embeds [B, P, pd]) -> activations
    [B, (P +) S, D] in ``compute_dtype``, the image prefix first."""
    x = embed_apply(params["embed"], batch["tokens"], cfg,
                    mp=_sub(mp, "embed"))
    if cfg.family == "vlm":
        cdt = cfg.compute_dtype
        pe = batch["patch_embeds"].to(cdt)
        if mp is None:
            pe = pe @ params["patch_proj"].to(cdt)
        else:                      # column-parallel, gathered for the concat
            split = mp.spec("patch_proj")[-1:] == ("model",)
            pe = pe @ mp.leaf(params, "patch_proj",
                              {-1: "model"} if split else None).to(cdt)
            if split:
                pe = sharding.gather(pe, -1, mp.group("model"))
        x = torch.cat([pe, x], dim=1)
    return constrain_batch(x, mp)


def _train_block(pl: dict, x: torch.Tensor, positions, cfg: LMConfig,
                 mp=None):
    x, _, aux = _block(pl, x, cfg, positions, mp=mp)
    return x, aux


def _layers_mp(mp):
    return None if mp is None else mp.sub("layers").layer()


def forward(params: dict, batch: dict, cfg: LMConfig, mp=None):
    """Full-sequence forward: returns (logits [B, S, V], moe_aux), the
    auxiliary loss summed over the layers (0 without MoE)."""
    x = _embed_inputs(params, batch, cfg, mp)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    remat = remat_on(cfg)
    mpl = _layers_mp(mp)
    for pl in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, a = checkpoint(_train_block, pl, x, positions, cfg, mpl,
                              use_reentrant=False)
        else:
            x, a = _train_block(pl, x, positions, cfg, mpl)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg, mp=_sub(mp, "embed")), aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            mp=None) -> torch.Tensor:
    """Next-token cross-entropy of :func:`forward` over the text positions
    (a vlm's image prefix is cut off), plus the MoE auxiliary loss."""
    logits, aux = forward(params, batch, cfg, mp)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                        mp=mp) + aux


# ---------------------------------------------------------------------------
# inference: prefill + decode
# ---------------------------------------------------------------------------

def cache_positions(max_len: int, mp=None) -> int:
    """Positions of the KV cache one rank holds: ``max_len``, or max_len /
    P with the sequence over the P ``model`` ranks (``cache_specs``)."""
    if mp is None:
        return max_len
    if max_len % mp.m:
        raise ValueError(f"the KV cache's {max_len} positions do not split "
                         f"over {mp.m} model ranks")
    return max_len // mp.m


def prefill(params: dict, batch: dict, cfg: LMConfig,
            max_len: int | None = None, mp=None):
    """Builds the KV cache over the prompt; returns (last_logits [B, 1, V],
    cache, pos = S, a vlm's patches included)."""
    x = _embed_inputs(params, batch, cfg, mp)
    b, s, _ = x.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    positions = torch.arange(s, device=x.device)
    cache = init_kv_cache(cfg, b, cache_positions(max_len, mp),
                          layers_dim=cfg.n_layers, device=x.device)
    mpl = _layers_mp(mp)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                         kv_cache=layer_cache, cache_pos=0, mp=mpl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (unembed_apply(params["embed"], x[:, -1:], cfg,
                          mp=_sub(mp, "embed")), cache, s)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig, mp=None):
    """One decode step: tokens [B] -> (logits [B, 1, V], cache).

    ``pos`` (an int) is the number of tokens already in the cache; the
    cache is written at ``pos`` in place and attention masks positions
    beyond it."""
    held = cache["k"].shape[2] * (1 if mp is None else mp.m)
    if pos >= held:
        raise ValueError(f"the cache holds {held} positions; decode at "
                         f"position {pos}")
    x = embed_apply(params["embed"], tokens[:, None], cfg,
                    mp=_sub(mp, "embed"))
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    mpl = _layers_mp(mp)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                         kv_cache=layer_cache, cache_pos=pos, mp=mpl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg, mp=_sub(mp, "embed")), cache
