"""Building blocks of the LMs — the port of ``repro.models.layers``
(configs, initializers, norms, rotary embeddings, attention with a KV
cache and cross-attention, the gated MLP, the MoE layer, embedding and the
cross-entropy).

Functional, as in the JAX package: ``init_*`` build dicts of tensors,
``*_apply`` consume them, and weights keep the JAX layout ``[d_in, d_out]``
so ``x @ w`` reads as there.  ``LMConfig``'s dtypes are torch dtypes.
``attn_impl`` and ``shard_attn_batch`` are kept as fields but do not route:
attention over 1024 or more tokens goes through ``kernels/ops.flash_attention``
(the CUDA kernel on a CUDA tensor, its plain version on a CPU one) when the
kernel takes its head width, else through the plain blockwise
:func:`flash_attention`.  Not ported: ``constrain_batch`` and
``_context_parallel_flash`` (mesh sharding, no meaning on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.bandit import top_k
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import NEG_LOGIT, flash_attention_ref


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    family: str = "dense"        # dense | moe | vlm | xlstm | griffin | encdec
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    d_head: int | None = None    # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int | None = None
    moe: MoEConfig | None = None
    lru_width: int | None = None
    block_pattern: tuple = ()
    mlstm_chunk: int = 256
    n_enc_layers: int = 0
    n_patches: int = 0
    patch_embed_dim: int = 0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    attn_impl: str = "xla"       # kept for parity; routing is by device
    max_seq: int = 8192
    shard_attn_batch: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


# ---------------------------------------------------------------------------
# initializers (explicit generators; the JAX package's keys do not carry over)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * d_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    dt = x.dtype
    x = x.float()
    ms = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(ms + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [S] or [B, S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs
    if angles.dim() == 2:                                   # [S, Dh/2]
        angles = angles[None, :, None, :]
    else:                                                   # [B, S, Dh/2]
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0, kv_valid_len: int | None = None,
                    q_block: int = 512, kv_block: int = 1024) -> torch.Tensor:
    """Blockwise attention with online softmax over q [B, Sq, KV, G, dh] and
    k, v [B, Skv, KV, dh].  This is ``kernels/ref.flash_attention_ref``, the
    plain version of the attention kernel, with its extra masks (sliding
    ``window``, ``q_offset`` of the first query, ``kv_valid_len``); unlike
    the JAX function it takes lengths that are not block multiples."""
    return flash_attention_ref(q, k, v, causal, window=window,
                               q_offset=q_offset, kv_valid_len=kv_valid_len,
                               q_block=q_block, kv_block=kv_block)


FLASH_MIN_SEQ = 1024      # below this the naive einsum path is taken


def _flash_ok(sq: int, skv: int) -> bool:
    """The blockwise route's length rule.  The JAX package also asks for
    block-divisible lengths; the kernel and its plain version mask the
    ragged edge, so the port does not."""
    return sq >= FLASH_MIN_SEQ or skv >= FLASH_MIN_SEQ


# ---------------------------------------------------------------------------
# attention (GQA + optional qk-norm / sliding window)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: LMConfig) -> dict:
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, cfg.d_model, h * dh, cfg.param_dtype),
        "wk": dense_init(gen, cfg.d_model, kv * dh, cfg.param_dtype),
        "wv": dense_init(gen, cfg.d_model, kv * dh, cfg.param_dtype),
        "wo": dense_init(gen, h * dh, cfg.d_model, cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, dtype=cfg.param_dtype, device=gen.device)
        p["k_norm"] = torch.zeros(dh, dtype=cfg.param_dtype, device=gen.device)
    return p


def _mha_mask(q_pos, kv_pos, window: int | None, causal: bool = True):
    """[Sq, Skv] boolean mask, True = attend."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - kv_pos[None, :] < window
    return m


def attention_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
                    positions: torch.Tensor, kv_cache: dict | None = None,
                    cache_pos: int | None = None, cross_kv=None,
                    window: int | None = None, causal: bool = True):
    """Returns (out [B, S, D], kv_cache or None).

    * training / forward: ``kv_cache`` None, self-attention over x.
    * prefill: ``kv_cache`` a dict of preallocated [B, max_len, KV, dh]
      buffers and ``cache_pos`` 0; decode: x is [B, 1, D] and ``cache_pos``
      the tokens already cached.  The cache is written IN PLACE at
      ``cache_pos`` (the JAX function returns an updated copy) and returned.
    * cross-attention: ``cross_kv`` the encoder output [B, Senc, D]; K and
      V come from it, with no rope, no mask and no cache (returns None for
      the cache), and ``causal`` is taken as False.

    Routes, decided by shape before any launch: S > 1 with ``_flash_ok``
    over the attended keys goes blockwise — through ``ops.flash_attention``
    (the CUDA kernel on the card) when the keys are exactly x's own (no
    cache, or a prefill at position 0) or the encoder's, there is no window
    and the kernel takes the head width (``HEAD_DIMS``), else through the
    plain :func:`flash_attention` with its masks (kimi-k2's dh 112 at full
    width); everything else (decode, prompts under 1024 tokens) is the
    einsum path.  A prefill at position 0 attends causally over its own
    keys, so the kernel sees the prompt's k and v, not the max_len cache:
    the same function as the JAX package's masked pass over the cache.
    """
    b, s, _ = x.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cdt = cfg.compute_dtype
    cross = cross_kv is not None
    src = cross_kv if cross else x

    q = (x @ p["wq"].to(cdt)).view(b, s, h, dh)
    k = (src @ p["wk"].to(cdt)).view(b, src.shape[1], kv, dh)
    v = (src @ p["wv"].to(cdt)).view(b, src.shape[1], kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cross:
        causal, window, kv_cache = False, None, None
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        kv_cache["k"][:, cache_pos:cache_pos + s] = k
        kv_cache["v"][:, cache_pos:cache_pos + s] = v
    q = q.reshape(b, s, kv, cfg.q_per_kv, dh)
    n_keys = k.shape[1] if kv_cache is None else cache_pos + s
    if s > 1 and _flash_ok(s, n_keys):
        if window is None and n_keys == k.shape[1] and dh in HEAD_DIMS:
            out = ops.flash_attention(q, k, v, causal)
        else:
            ck = k if kv_cache is None else kv_cache["k"][:, :n_keys]
            cv = v if kv_cache is None else kv_cache["v"][:, :n_keys]
            off = 0 if kv_cache is None else cache_pos
            out = flash_attention(q, ck, cv, causal=causal, window=window,
                                  q_offset=off)
        out = out.reshape(b, s, h * dh).to(cdt)
    else:
        if kv_cache is not None:
            k, v = kv_cache["k"], kv_cache["v"]
        logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() * dh ** -0.5
        if not cross:
            kv_pos = torch.arange(k.shape[1], device=x.device)
            q_pos = positions if positions.dim() == 1 else positions[0]
            mask = _mha_mask(q_pos, kv_pos, window, causal=causal)
            if kv_cache is not None:
                mask = mask & (kv_pos <= cache_pos + s - 1)[None, :]
            logits = torch.where(mask, logits, NEG_LOGIT)
        attn = torch.softmax(logits, dim=-1).to(cdt)
        out = torch.einsum("bkgst,btkd->bskgd", attn, v).reshape(b, s, h * dh)
    return out @ p["wo"].to(cdt), kv_cache


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  layers_dim: int | None = None, device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if layers_dim is not None:
        shape = (layers_dim,) + shape
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: LMConfig,
             d_ff: int | None = None) -> dict:
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, cfg.d_model, f, cfg.param_dtype),
        "w_up": dense_init(gen, cfg.d_model, f, cfg.param_dtype),
        "w_down": dense_init(gen, f, cfg.d_model, cfg.param_dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    g = F.silu(x @ p["w_gate"].to(cdt))
    u = x @ p["w_up"].to(cdt)
    return (g * u) @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# MoE: top-k router + capacity-based scatter/gather dispatch (sort-free)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Router [D, E] float32, experts' ``w_gate``/``w_up`` [E, D, F] and
    ``w_down`` [E, F, D]; with ``n_shared`` a shared expert, a gated MLP of
    width ``d_ff_expert * n_shared``."""
    mc = cfg.moe
    e, f, d = mc.n_experts, mc.d_ff_expert, cfg.d_model

    def experts(*shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(cfg.param_dtype)
    p = {"router": dense_init(gen, d, e, torch.float32),
         "w_gate": experts(e, d, f, scale=d ** -0.5),
         "w_up": experts(e, d, f, scale=d ** -0.5),
         "w_down": experts(e, f, d, scale=f ** -0.5)}
    if mc.n_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=f * mc.n_shared)
    return p


def moe_capacity(n_tokens: int, mc: MoEConfig) -> int:
    """Slots per expert: Python's ``round`` on Python floats (half to even),
    as the JAX package computes it."""
    return int(max(1, round(n_tokens * mc.top_k / mc.n_experts
                            * mc.capacity_factor)))


def moe_route(xt: torch.Tensor, router: torch.Tensor, mc: MoEConfig):
    """The router over [T, D] tokens: (probs [T, E] float32, expert indices
    [T, k]) — ``lax.top_k``'s indices: value descending, ties to the lower
    index."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    return probs, top_k(probs.detach(), mc.top_k)


def moe_slots(idx: torch.Tensor, mc: MoEConfig):
    """Where each of the [T * k] assignments (token-major) goes: (slot in
    the [E * cap] buffer, or ``E * cap`` when dropped; keep bool; cap).  An
    assignment's place within its expert counts the assignments to that
    expert before it in token-major [T, k] order, so the same tokens
    overflow as in the JAX package."""
    cap = moe_capacity(idx.shape[0], mc)
    flat_e = idx.reshape(-1)
    # [E, T * k], so the count runs along the contiguous axis
    onehot = F.one_hot(flat_e, mc.n_experts).t().contiguous()
    before = (onehot.cumsum(1) - onehot).gather(0, flat_e[None])[0]
    keep = before < cap
    slot = torch.where(keep, flat_e * cap + before,
                       torch.full_like(flat_e, mc.n_experts * cap))
    return slot, keep, cap


def moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig):
    """Returns (out [B, S, D], aux_loss scalar).  Capacity-dropping
    dispatch: an expert takes at most ``moe_capacity(B * S)`` assignments
    and drops the rest (GShard/Switch semantics); the kept tokens are
    scattered into [E, cap, D] buffers, every expert runs its SwiGLU as
    dense batched matmuls [E, cap, D] x [E, D, F], and the results are
    gathered back, weighted by the renormalised gates and summed per token.
    The auxiliary loss is Switch's, E * sum_e f_e * p_e times
    ``router_aux_weight``, with f_e the share of tokens whose first choice
    is e."""
    mc = cfg.moe
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    e, k = mc.n_experts, mc.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, idx = moe_route(xt, p["router"], mc)
    gate = probs.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    slot, keep, cap = moe_slots(idx, mc)
    ce = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (probs.mean(0) * ce).sum() * mc.router_aux_weight

    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = xt.new_zeros((e * cap + 1, d), dtype=cdt)
    buf = buf.index_put((slot,), xt[tok].to(cdt))      # row E*cap: dropped
    ebuf = buf[:-1].view(e, cap, d)
    g = F.silu(torch.bmm(ebuf, p["w_gate"].to(cdt)))
    u = torch.bmm(ebuf, p["w_up"].to(cdt))
    y = torch.bmm(g * u, p["w_down"].to(cdt)).view(e * cap, d)
    y = torch.cat([y, y.new_zeros((1, d))])
    w = (gate.reshape(-1) * keep).to(cdt)
    out = (y[slot] * w[:, None]).view(t, k, d).sum(1)
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], xt, cfg)
    return out.view(b, s, d), aux


# ---------------------------------------------------------------------------
# LM head / embedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: LMConfig) -> dict:
    p = {"tok": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype)
    return p


def embed_apply(p: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    return p["tok"][tokens].to(cfg.compute_dtype)      # gather, then cast


def unembed_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["tok"].to(cfg.compute_dtype).T
    else:
        w = p["unembed"].to(cfg.compute_dtype)
    return x @ w


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy in float32; logits [.., V], labels [..] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()
