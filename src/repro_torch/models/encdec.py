"""Encoder-decoder backbone (seamless-m4t-medium) — the port of
``repro.models.encdec``.

Only the transformer backbone is modelled; the speech frontend is a stub:
the batch carries precomputed frame embeddings ``frames`` [B, S_enc,
d_model] (what the conv/fbank frontend would emit) beside the decoder's
``tokens`` [B, S_dec].  The encoder is pre-RMSNorm self-attention without
a causal mask, then the gated MLP; each decoder layer runs causal
self-attention, cross-attention to the encoder output, then the MLP.
Attention routes as ``layers.attention_apply`` says: at 1024 or more
tokens the encoder, the decoder's prefill self-attention and its
cross-attention go through ``ops.flash_attention`` (the CUDA kernel on the
card; full for the encoder and cross-attention, causal for the decoder).

Parameters keep the JAX package's tree: ``enc_layers`` and ``dec_layers``
with every leaf stacked on a leading [L] axis (``{attn_norm, attn,
mlp_norm, mlp}`` and ``{self_norm, self_attn, cross_norm, cross_attn,
mlp_norm, mlp}``), ``embed.tok``, ``unembed``, ``enc_norm``, ``dec_norm``.
The decode cache is ``{"self": {"k", "v"} [L, B, max_len, KV, dh],
"enc_out": [B, S_enc, d_model]}``; decode writes the self-attention cache
in place and, as the JAX package does, recomputes each layer's cross K and
V from ``enc_out`` every step.  With ``cfg.remat`` and grad mode on,
``forward`` runs each encoder and decoder layer under
``torch.utils.checkpoint``.

With ``mp`` (a ``layers.ModelParallel``) the blocks take the same routes as
the transformer's (models/layers.py): head-parallel or gathered self- and
cross-attention, the TP MLP, the vocab-parallel embedding and logits, and
the self-attention cache's sequence over ``model``; ``enc_out`` holds the
rank's batch rows.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (LMConfig, _sub, attention_apply,
                                       constrain_batch, dense_init,
                                       embed_apply, embed_init,
                                       init_attention, init_kv_cache,
                                       init_mlp, mlp_apply, rms_norm,
                                       softmax_xent, vocab_logits)
from repro_torch.models.transformer import (_layer, _unstack,
                                            cache_positions, init_stacked,
                                            remat_on, whole)


def _zeros(gen: torch.Generator, cfg: LMConfig) -> torch.Tensor:
    return torch.zeros(cfg.d_model, dtype=cfg.param_dtype, device=gen.device)


def _init_enc_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {"attn_norm": _zeros(gen, cfg), "attn": init_attention(gen, cfg),
            "mlp_norm": _zeros(gen, cfg), "mlp": init_mlp(gen, cfg)}


def _init_dec_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {"self_norm": _zeros(gen, cfg),
            "self_attn": init_attention(gen, cfg),
            "cross_norm": _zeros(gen, cfg),
            "cross_attn": init_attention(gen, cfg),
            "mlp_norm": _zeros(gen, cfg), "mlp": init_mlp(gen, cfg)}


def init(generator: torch.Generator, cfg: LMConfig, keep=whole) -> dict:
    """Random parameters drawn from ``generator``, on its device, each
    subtree through ``keep`` as it is drawn (``transformer.init``)."""
    return {
        "enc_layers": init_stacked(
            lambda: keep("enc_layers", _init_enc_layer(generator, cfg), 1),
            cfg.n_enc_layers),
        "dec_layers": init_stacked(
            lambda: keep("dec_layers", _init_dec_layer(generator, cfg), 1),
            cfg.n_layers),
        "embed": keep("embed", {"tok": embed_init(
            generator, cfg.vocab, cfg.d_model, cfg.param_dtype)}),
        "unembed": keep("unembed", dense_init(
            generator, cfg.d_model, cfg.vocab, cfg.param_dtype)),
        "enc_norm": keep("enc_norm", _zeros(generator, cfg)),
        "dec_norm": keep("dec_norm", _zeros(generator, cfg)),
    }


def _enc_block(pl: dict, x: torch.Tensor, positions, cfg: LMConfig,
               mp=None):
    h, _ = attention_apply(pl["attn"], rms_norm(x, pl["attn_norm"],
                                                cfg.norm_eps),
                           cfg, positions, causal=False, mp=_sub(mp, "attn"))
    x = x + h
    x = x + mlp_apply(pl["mlp"], rms_norm(x, pl["mlp_norm"], cfg.norm_eps),
                      cfg, mp=_sub(mp, "mlp"))
    return constrain_batch(x, mp)


def _stack_mp(mp, key: str):
    return None if mp is None else mp.sub(key).layer()


def encode(params: dict, frames: torch.Tensor, cfg: LMConfig, mp=None):
    """frames [B, S_enc, d_model] (the frontend stub's output) -> the
    normalised encoder output in ``compute_dtype``."""
    x = frames.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat_on(cfg)
    mpl = _stack_mp(mp, "enc_layers")
    for pl in _unstack(params["enc_layers"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(_enc_block, pl, x, positions, cfg, mpl,
                           use_reentrant=False)
        else:
            x = _enc_block(pl, x, positions, cfg, mpl)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(pl: dict, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: LMConfig, positions, kv_cache=None, cache_pos=None,
               mp=None):
    h, kv_cache = attention_apply(
        pl["self_attn"], rms_norm(x, pl["self_norm"], cfg.norm_eps), cfg,
        positions, kv_cache=kv_cache, cache_pos=cache_pos,
        mp=_sub(mp, "self_attn"))
    x = x + h
    h, _ = attention_apply(
        pl["cross_attn"], rms_norm(x, pl["cross_norm"], cfg.norm_eps), cfg,
        positions, cross_kv=enc_out, mp=_sub(mp, "cross_attn"))
    x = x + h
    x = x + mlp_apply(pl["mlp"], rms_norm(x, pl["mlp_norm"], cfg.norm_eps),
                      cfg, mp=_sub(mp, "mlp"))
    return constrain_batch(x, mp), kv_cache


def _train_dec_block(pl, x, enc_out, positions, cfg, mp=None):
    return _dec_block(pl, x, enc_out, cfg, positions, mp=mp)[0]


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig,
            mp=None) -> torch.Tensor:
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    if mp is not None:
        return vocab_logits(x, params, "unembed", 1, cfg, mp)
    return x @ params["unembed"].to(cfg.compute_dtype)


def forward(params: dict, batch: dict, cfg: LMConfig, mp=None):
    """Encoder over ``frames``, decoder over ``tokens``: (logits [B, S_dec,
    V], aux = 0), the formulation of the JAX package's ``loss_fn``."""
    enc_out = encode(params, batch["frames"], cfg, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg,
                    mp=_sub(mp, "embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat_on(cfg)
    mpl = _stack_mp(mp, "dec_layers")
    for pl in _unstack(params["dec_layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_train_dec_block, pl, x, enc_out, positions, cfg,
                           mpl, use_reentrant=False)
        else:
            x = _train_dec_block(pl, x, enc_out, positions, cfg, mpl)
    return _logits(params, x, cfg, mp), torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            mp=None) -> torch.Tensor:
    """Next-token cross-entropy of the decoder's :func:`forward`."""
    logits, _ = forward(params, batch, cfg, mp)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], mp=mp)


def prefill(params: dict, batch: dict, cfg: LMConfig,
            max_len: int | None = None, mp=None):
    """Encodes the frames and runs the decoder over the prompt tokens,
    building its self-attention cache; returns (last_logits [B, 1, V],
    {"self", "enc_out"}, pos = S_dec)."""
    enc_out = encode(params, batch["frames"], cfg, mp)
    x = embed_apply(params["embed"], batch["tokens"], cfg,
                    mp=_sub(mp, "embed"))
    b, s, _ = x.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    positions = torch.arange(s, device=x.device)
    cache = init_kv_cache(cfg, b, cache_positions(max_len, mp),
                          layers_dim=cfg.n_layers, device=x.device)
    mpl = _stack_mp(mp, "dec_layers")
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = _dec_block(_layer(params["dec_layers"], i), x, enc_out, cfg,
                          positions, kv_cache=layer_cache, cache_pos=0,
                          mp=mpl)
    return (_logits(params, x[:, -1:], cfg, mp),
            {"self": cache, "enc_out": enc_out}, s)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig, mp=None):
    """One decoder token: tokens [B] at position ``pos`` -> (logits [B, 1,
    V], cache); the self-attention cache is written in place."""
    self_cache = cache["self"]
    held = self_cache["k"].shape[2] * (1 if mp is None else mp.m)
    if pos >= held:
        raise ValueError(f"the cache holds {held} positions; decode at "
                         f"position {pos}")
    x = embed_apply(params["embed"], tokens[:, None], cfg,
                    mp=_sub(mp, "embed"))
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    mpl = _stack_mp(mp, "dec_layers")
    for i in range(cfg.n_layers):
        layer_cache = {"k": self_cache["k"][i], "v": self_cache["v"][i]}
        x, _ = _dec_block(_layer(params["dec_layers"], i), x,
                          cache["enc_out"], cfg, positions,
                          kv_cache=layer_cache, cache_pos=pos, mp=mpl)
    return _logits(params, x, cfg, mp), cache
