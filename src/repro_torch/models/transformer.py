"""Decoder-only transformer, the dense family — the port of
``repro.models.transformer``.

Parameters are the JAX package's tree as a nested dict of tensors, the
per-layer ones stacked on a leading [L] axis (``layers.attn.wq`` is
[L, d_model, H * dh]); the layer stack is a Python loop over that axis where
the JAX package scans.  Entry points:

  * ``forward(params, batch, cfg)`` and ``loss_fn`` — the full sequence,
    differentiable (``launch/steps.make_train_step`` trains through it);
    with ``cfg.remat`` and grad mode on, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the JAX package wraps
    its scanned layer in ``jax.checkpoint``;
  * ``prefill(params, batch, cfg, max_len)`` — builds the KV cache;
  * ``decode_step(params, cache, tokens, pos, cfg)`` — one token.

The KV cache is ``{"k", "v"}`` of [L, B, max_len, KV, dh] in
``compute_dtype``; ``decode_step`` writes it in place (the JAX function
returns an updated copy) and returns it.  The ``moe`` and ``vlm`` families
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (LMConfig, attention_apply, embed_apply,
                                       init_attention, init_embed,
                                       init_kv_cache, init_mlp, mlp_apply,
                                       rms_norm, softmax_xent, unembed_apply)


def _dense_only(cfg: LMConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet (ROADMAP Queue 1 item 5)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: LMConfig) -> dict:
    zeros = lambda: torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                device=gen.device)
    return {"attn_norm": zeros(), "mlp_norm": zeros(),
            "attn": init_attention(gen, cfg), "mlp": init_mlp(gen, cfg)}


def _stack(trees: list[dict]) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def init(generator: torch.Generator, cfg: LMConfig) -> dict:
    """Random parameters drawn from ``generator``, on its device."""
    _dense_only(cfg)
    embed = init_embed(generator, cfg)
    layers = _stack([_init_layer(generator, cfg)
                     for _ in range(cfg.n_layers)])
    return {"embed": embed, "layers": layers,
            "final_norm": torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                      device=generator.device)}


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
           kv_cache=None, cache_pos=None):
    """One transformer block.  Returns (x, kv_cache, aux); the dense
    family's MoE auxiliary loss is 0."""
    h, kv_cache = attention_apply(
        pl["attn"], rms_norm(x, pl["attn_norm"], cfg.norm_eps), cfg,
        positions, kv_cache=kv_cache, cache_pos=cache_pos,
        window=cfg.sliding_window)
    x = x + h
    y = rms_norm(x, pl["mlp_norm"], cfg.norm_eps)
    m = mlp_apply(pl["mlp"], y, cfg)
    return x + m, kv_cache, 0.0


def _embed_inputs(params: dict, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """tokens [B, S] -> activations [B, S, D] in ``compute_dtype``."""
    _dense_only(cfg)
    return embed_apply(params["embed"], batch["tokens"], cfg)


def _train_block(pl: dict, x: torch.Tensor, positions, cfg: LMConfig):
    return _block(pl, x, cfg, positions)[0]


def forward(params: dict, batch: dict, cfg: LMConfig):
    """Full-sequence forward: returns (logits [B, S, V], moe_aux = 0)."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    remat = remat_on(cfg)
    for pl in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_train_block, pl, x, positions, cfg,
                           use_reentrant=False)
        else:
            x = _train_block(pl, x, positions, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg), aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """Next-token cross-entropy of :func:`forward`."""
    logits, aux = forward(params, batch, cfg)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:]) + aux


# ---------------------------------------------------------------------------
# inference: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params: dict, batch: dict, cfg: LMConfig,
            max_len: int | None = None):
    """Builds the KV cache over the prompt; returns (last_logits [B, 1, V],
    cache, pos = S)."""
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt {s}")
    positions = torch.arange(s, device=x.device)
    cache = init_kv_cache(cfg, b, max_len, layers_dim=cfg.n_layers,
                          device=x.device)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                         kv_cache=layer_cache, cache_pos=0)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, -1:], cfg), cache, s


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig):
    """One decode step: tokens [B] -> (logits [B, 1, V], cache).

    ``pos`` (an int) is the number of tokens already in the cache; the
    cache is written at ``pos`` in place and attention masks positions
    beyond it."""
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions; "
                         f"decode at position {pos}")
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                         kv_cache=layer_cache, cache_pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["embed"], x, cfg), cache
