"""Building blocks of the LMs — the port of ``repro.models.layers``
(configs, initializers, norms, rotary embeddings, attention with a KV
cache and cross-attention, the gated MLP, the MoE layer, embedding and the
cross-entropy).

Functional, as in the JAX package: ``init_*`` build dicts of tensors,
``*_apply`` consume them, and weights keep the JAX layout ``[d_in, d_out]``
so ``x @ w`` reads as there.  ``LMConfig``'s dtypes are torch dtypes.
``attn_impl`` is kept as a field but does not route: attention over 1024
or more tokens goes through ``kernels/ops.flash_attention`` (the CUDA
kernel on a CUDA tensor, its plain version on a CPU one) when the kernel
takes its head width, else through the plain blockwise
:func:`flash_attention`.

Model parallelism.  Every ``*_apply`` takes ``mp``, a :class:`ModelParallel`
(the device mesh's axis sizes, this rank's coordinates, its process groups
and the spec tree of the parameters the function gets), or None for one
process, where it is the one-process code operation for operation.  With
``mp`` the parameters are this rank's blocks (``distributed/sharding
.shard_params``) and activations hold this rank's B / n_data rows of the
batch (:func:`constrain_batch` checks it at every block boundary).  The
routes, by leaf:

  * column-parallel ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` (last dim
    over ``model``) and row-parallel ``wo``/``w_down`` (their rows), the
    block's output summed by ``all_reduce`` over ``model`` (in float32,
    rounded once to the compute dtype) — attention only
    when ``model`` divides the kv heads (then it divides the q heads, and
    a rank's q heads sit over its kv heads);
  * expert-parallel :func:`moe_apply`: the experts' E over ``model``, the
    routing computed whole on every rank, each rank's experts' gated
    outputs summed by ``all_reduce`` (the shared expert as a dense MLP);
  * vocab-parallel :func:`embed_apply` (each rank looks up its vocab rows,
    the others' tokens give zeros, summed by ``all_reduce``) and
    :func:`vocab_logits` (the logits all-gathered along the vocab for the
    caller), ``patch_proj`` column-parallel with its output all-gathered;
  * context-parallel attention for ``cfg.shard_attn_batch`` (llava's 56 q
    heads): a prefill over the blockwise route gives rank r the q rows
    [r·S/P, (r+1)·S/P) with all of k and v, attending through
    ``ops.flash_attention(..., q_offset=r·S/P)`` (the kernel on the card),
    and all-gathers the block's output along the sequence;
  * gather before use: a leaf whose spec splits a dim that the local
    computation cannot consume is all-gathered first, as GSPMD would
    reshard it — every ``data`` (FSDP) dim; the attention weights when
    ``model`` does not divide the kv heads (smollm's 3 on 2 ranks), and
    always on the context-parallel route; a block whose column and row
    weights are not both split the same way.
  * the KV cache follows ``cache_specs``: the sequence over ``model``
    (:func:`init_kv_cache` of max_len / P positions a rank; max_len must be
    a multiple of P).  A prefill writes its positions of every head's k and
    v (all-gathered over the heads on the TP route); a decode step writes
    the new token on the rank that owns its position and attends over each
    rank's positions, combining the partial results as split-KV decoding
    does: a max ``all_reduce`` of the local maxima, then a sum
    ``all_reduce`` of the rescaled sums and one of the rescaled outputs.

Under autograd (training over a mesh, ``launch/steps.make_train_step``)
every collective of the routes above but the serving-only ones (the KV
cache's, split-KV decoding's, the MoE's gather of expert choices) is an
autograd Function of ``distributed/sharding.py``, whose module docstring
has the table of call sites and their backward rules; a replicated input
meets column-parallel work through :meth:`ModelParallel.copy`.
:func:`softmax_xent` takes ``mp`` and then averages over the global
batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.bandit import top_k
from repro_torch.distributed import sharding
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
# model parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """One rank of a device mesh, as the model functions see it: the mesh's
    axis sizes and this rank's coordinates ({name: int}, mesh order), its
    process group along each axis, the spec tree of the parameters the
    callee is given (narrowed by :meth:`sub` and :meth:`layer` on the way
    down), the batch rows an activation holds here (None: unchecked), and
    the group over the batch axes when the batch is split over them (the
    MoE layer routes over the whole batch through it)."""

    sizes: dict
    coords: dict
    groups: dict
    specs: Any = None
    local_batch: int | None = None
    batch_group: Any = None

    @classmethod
    def of(cls, mesh, specs, global_batch: int, split_batch: bool = True):
        """This rank of ``mesh`` (a ``DeviceMesh``) for parameters of the
        spec tree ``specs``; ``global_batch`` the batch the caller split
        over the batch axes as ``sharding.batch_specs`` does (whole when
        they do not divide it, or with ``split_batch`` False: every rank
        of a batch axis then holds the same batch, as a cohort of
        ``distributed/fl_parallel.make_fl_round`` does)."""
        sizes = sharding.axis_sizes(mesh)
        ba = sharding.batch_axes(sizes)
        n = sharding.axis_size(sizes, ba)
        split = split_batch and global_batch > 1 and global_batch % n == 0
        group = None
        if split:
            group = (mesh.get_group(ba[0]) if len(ba) == 1
                     else mesh[ba]._flatten().get_group())
        return cls(sizes, sharding.mesh_coords(mesh),
                   {a: mesh.get_group(a) for a in sizes}, specs,
                   global_batch // n if split else global_batch, group)

    @property
    def batch_block(self) -> int:
        """This rank's block of the batch (0 when it is whole)."""
        if self.batch_group is None:
            return 0
        return sharding.block_index(sharding.batch_axes(self.sizes),
                                    self.coords, self.sizes)

    @property
    def m(self) -> int:
        """Ranks along ``model``."""
        return self.sizes.get("model", 1)

    @property
    def r(self) -> int:
        """This rank's index along ``model``."""
        return self.coords.get("model", 0)

    def group(self, axis: str):
        return self.groups[axis]

    def sub(self, *keys) -> "ModelParallel":
        """The same rank for the subtree ``params[keys[0]][keys[1]]...``."""
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return dataclasses.replace(self, specs=specs)

    def layer(self) -> "ModelParallel":
        """The same rank for one slice of [L]-stacked leaves: every spec
        without its leading entry."""
        return dataclasses.replace(self, specs=sharding.map_with_path(
            lambda _, s: sharding.Spec(s[1:]), self.specs))

    def spec(self, key) -> tuple:
        return self.specs[key]

    @property
    def split_axes(self) -> tuple:
        """The axes whose ranks each work on their own rows of the batch:
        the batch axes when the batch is split over them, else none."""
        if self.batch_group is None:
            return ()
        return sharding.batch_axes(self.sizes)

    def gather(self, x: torch.Tensor, spec, keep: dict | None = None,
               split: tuple = ()):
        """``x`` all-gathered along every dim its ``spec`` splits, but the
        dims of ``keep`` ({dim: axis}, dims may count from the end) that
        stay split over that axis.  Under autograd a gather over an axis of
        ``split`` or :attr:`split_axes` is ``sharding.GatherSplit`` (each
        rank uses the leaf on its own share of the work), over any other
        axis ``sharding.GatherReplicated``."""
        keep = {d % x.dim(): a for d, a in (keep or {}).items()}
        for dim, axis in enumerate(spec):
            if axis is None or keep.get(dim) == axis:
                continue
            if not isinstance(axis, str):
                raise ValueError(f"cannot gather over the axes {axis}")
            x = sharding.gather(x, dim, self.groups[axis],
                                split=axis in split or axis in
                                self.split_axes)
        return x

    def leaf(self, p: dict, key, keep: dict | None = None,
             split: tuple = ()) -> torch.Tensor:
        """``p[key]`` gathered as :meth:`gather` says, by its spec."""
        return self.gather(p[key], self.spec(key), keep, split)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, the same on every ``model`` rank, where it enters work
        split over ``model`` (``sharding.CopyToParallel``)."""
        return sharding.copy_to_parallel(x, self.group("model"))

    def gather_tree(self, tree):
        """Every leaf of ``tree`` (whose specs this is) gathered whole."""
        specs = self.specs
        return sharding.map_with_path(
            lambda path, x: self.gather(x, sharding.spec_at(specs, path)),
            tree)


def _sub(mp: ModelParallel | None, *keys):
    return None if mp is None else mp.sub(*keys)


def _row_sum(y: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """The row-parallel partial outputs ``y`` summed over ``model`` in
    float32 and rounded once to y's dtype, as one process's matmul rounds
    its float32 sums (exact at one rank); ``sharding.SumPartials``."""
    return sharding.sum_partials(y.float(), mp.group("model")).to(y.dtype)


def _ax(spec, dim: int):
    """The axis ``spec`` puts on ``dim`` (None for a replicated leaf)."""
    return spec[dim] if spec else None


def constrain_batch(x: torch.Tensor, mp: ModelParallel | None,
                    batch_dim: int = 0) -> torch.Tensor:
    """Check that an activation holds this rank's B / n_data rows of the
    batch (the port of the JAX package's sharding constraint, applied at
    every residual-block boundary): ``x`` itself, or ValueError.  A no-op
    for one process (``mp`` None) or an unchecked batch."""
    if mp is not None and mp.local_batch is not None \
            and x.shape[batch_dim] != mp.local_batch:
        raise ValueError(f"an activation holds {x.shape[batch_dim]} batch "
                         f"rows; this rank's share is {mp.local_batch}")
    return x


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


def _leaf(p: dict, key, mp: ModelParallel | None, keep: dict | None = None):
    """``p[key]``; with ``mp``, gathered as :meth:`ModelParallel.gather`
    says."""
    return p[key] if mp is None else mp.leaf(p, key, keep)


def _qkv(p: dict, xq, xkv, w, n_q: int, n_kv: int, cfg: LMConfig,
         q_pos=None, k_pos=None):
    """q [B, Sq, n_q, dh] of ``xq`` and k, v [B, Skv, n_kv, dh] of ``xkv``
    by the weights ``w`` = (wq, wk, wv) in ``compute_dtype``, then qk-norm
    and, given positions, rope (none for cross-attention)."""
    cdt, dh = cfg.compute_dtype, cfg.head_dim
    q = (xq @ w[0].to(cdt)).view(*xq.shape[:2], n_q, dh)
    k = (xkv @ w[1].to(cdt)).view(*xkv.shape[:2], n_kv, dh)
    v = (xkv @ w[2].to(cdt)).view(*xkv.shape[:2], n_kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if q_pos is not None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k, v


def _blockwise(q, k, v, causal: bool, window, kv_cache=None,
               cache_pos: int = 0):
    """The blockwise route over q [B, S, KV, G, dh]: ``ops.flash_attention``
    (the kernel on the card) when the keys are exactly ``k``/``v`` (no
    cache, or a prefill at position 0), there is no window and the kernel
    takes the head width; else the plain :func:`flash_attention` with its
    masks over the cached positions [0, cache_pos + S)."""
    n_keys = k.shape[1] if kv_cache is None else cache_pos + q.shape[1]
    if window is None and n_keys == k.shape[1] and q.shape[-1] in HEAD_DIMS:
        return ops.flash_attention(q, k, v, causal)
    if kv_cache is not None:
        k, v = kv_cache["k"][:, :n_keys], kv_cache["v"][:, :n_keys]
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=0 if kv_cache is None else cache_pos)


def _softmax_attention(q, k, v, q_pos, kv_pos, window, causal: bool, cdt,
                       last: int | None = None):
    """The einsum route over q [B, S, KV, G, dh] and k, v [B, T, KV, dh]:
    (out [B, S, KV, G, dh] in ``cdt``, the float32 logits [B, KV, G, S,
    T] as masked).  ``q_pos`` None (cross-attention) masks nothing; else
    the causal and window masks of positions ``q_pos`` against
    ``kv_pos``, and with ``last`` no key beyond that position."""
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() \
        * q.shape[-1] ** -0.5
    if q_pos is not None:
        mask = _mha_mask(q_pos, kv_pos, window, causal=causal)
        if last is not None:
            mask = mask & (kv_pos <= last)[None, :]
        logits = torch.where(mask, logits, NEG_LOGIT)
    attn = torch.softmax(logits, dim=-1).to(cdt)
    return torch.einsum("bkgst,btkd->bskgd", attn, v), logits


def attention_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
                    positions: torch.Tensor, kv_cache: dict | None = None,
                    cache_pos: int | None = None, cross_kv=None,
                    window: int | None = None, causal: bool = True,
                    mp: ModelParallel | None = None):
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
    over the attended keys goes blockwise (:func:`_blockwise`: through
    ``ops.flash_attention``, the CUDA kernel on the card, when the keys
    are exactly x's own or the encoder's, there is no window and the
    kernel takes the head width, else through the plain
    :func:`flash_attention` with its masks, kimi-k2's dh 112 at full
    width); everything else (decode, prompts under 1024 tokens) is the
    einsum path.  A prefill at position 0 attends causally over its own
    keys, so the kernel sees the prompt's k and v, not the max_len cache:
    the same function as the JAX package's masked pass over the cache.

    With ``mp`` the rank's blocks of the weights and cache go through
    :func:`_attention_mp` (the module docstring's routes).
    """
    b, s, _ = x.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cdt = cfg.compute_dtype
    cross = cross_kv is not None
    src = cross_kv if cross else x
    if cross:
        causal, window, kv_cache = False, None, None
    n_keys = src.shape[1] if kv_cache is None else cache_pos + s
    blockwise = s > 1 and _flash_ok(s, n_keys)
    if mp is not None:
        return _attention_mp(p, x, src, cfg, positions, kv_cache, cache_pos,
                             window, causal, blockwise, mp)
    q, k, v = _qkv(p, x, src, (p["wq"], p["wk"], p["wv"]), h, kv, cfg,
                   *((None, None) if cross else (positions, positions)))
    if kv_cache is not None:
        kv_cache["k"][:, cache_pos:cache_pos + s] = k
        kv_cache["v"][:, cache_pos:cache_pos + s] = v
    q = q.reshape(b, s, kv, cfg.q_per_kv, dh)
    if blockwise:
        out = _blockwise(q, k, v, causal, window, kv_cache, cache_pos)
    else:
        if kv_cache is not None:
            k, v = kv_cache["k"], kv_cache["v"]
        out, _ = _softmax_attention(
            q, k, v, None if cross else _q_pos(positions),
            torch.arange(k.shape[1], device=x.device), window, causal, cdt,
            None if kv_cache is None else cache_pos + s - 1)
    return out.reshape(b, s, h * dh).to(cdt) @ p["wo"].to(cdt), kv_cache


def _q_pos(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.dim() == 1 else positions[0]


def _context_parallel_flash(q, k, v, causal: bool, mp: ModelParallel):
    """Rank r's q rows [r·S/P, (r+1)·S/P) (``q`` [B, S/P, KV, G, dh], P the
    ``model`` ranks) against all of ``k``/``v`` [B, S, KV, dh]: query i of
    the block sits at position r·S/P + i, so the kernel masks with that
    ``q_offset`` and gives exactly those rows of the unsplit attention."""
    return ops.flash_attention(q, k, v, causal, q_offset=mp.r * q.shape[1])


def _write_cache(kv_cache: dict, k, v, cache_pos: int, mp: ModelParallel):
    """Write positions [cache_pos, cache_pos + S) of every head's ``k``,
    ``v`` [B, S, KV, dh] into this rank's slice of the cache, positions
    [r·L/P, (r+1)·L/P)."""
    n = kv_cache["k"].shape[1]
    lo = mp.r * n
    a, e = max(cache_pos, lo), min(cache_pos + k.shape[1], lo + n)
    if a < e:
        kv_cache["k"][:, a - lo:e - lo] = k[:, a - cache_pos:e - cache_pos]
        kv_cache["v"][:, a - lo:e - lo] = v[:, a - cache_pos:e - cache_pos]


def _split_kv_attention(q, kv_cache: dict, cache_pos: int, q_pos, window,
                        causal: bool, cdt, mp: ModelParallel):
    """Attention of ``q`` [B, S, KV, G, dh] (every head) over the cached
    positions [0, cache_pos + S), each rank over its slice of them: the
    one-process softmax and product on the slice, then the slices combined
    (split-KV decoding) by a max ``all_reduce`` of the local maxima m_r,
    a sum ``all_reduce`` of the weights w_r = l_r · exp(m_r - m) (l_r the
    local sum of exp(logit - m_r)) and a sum ``all_reduce`` of the local
    outputs times w_r / sum(w).  With one rank the weight is l / l = 1
    exactly, so the result is the one-process attention bit for bit.
    Returns [B, S, KV, G, dh] in ``cdt``."""
    n = kv_cache["k"].shape[1]
    kv_pos = mp.r * n + torch.arange(n, device=q.device)
    out, logits = _softmax_attention(q, kv_cache["k"], kv_cache["v"], q_pos,
                                     kv_pos, window, causal, cdt,
                                     cache_pos + q.shape[1] - 1)
    grp = mp.group("model")
    m_r = logits.amax(-1)
    l_r = torch.exp(logits - m_r[..., None]).sum(-1)
    m = sharding.all_reduce_max(m_r.clone(), grp)
    w_r = l_r * torch.exp(m_r - m)
    w = sharding.all_reduce(w_r.clone(), grp)
    scale = (w_r / w).permute(0, 3, 1, 2)[..., None]        # [B, S, KV, G, 1]
    return sharding.all_reduce(scale * out.float(), grp).to(cdt)


def _copied_norms(p: dict, cfg: LMConfig, mp: ModelParallel) -> dict:
    """``p`` with its qk-norm scales through :meth:`ModelParallel.copy`:
    applied to this rank's heads or rows, their gradients are partial."""
    if not cfg.qk_norm:
        return p
    return {**p, "q_norm": mp.copy(p["q_norm"]),
            "k_norm": mp.copy(p["k_norm"])}


def _attention_mp(p: dict, x: torch.Tensor, src: torch.Tensor, cfg: LMConfig,
                  positions, kv_cache, cache_pos, window, causal,
                  blockwise: bool, mp: ModelParallel):
    """:func:`attention_apply` on this rank's blocks (routes in the module
    docstring): context-parallel for ``cfg.shard_attn_batch`` on the
    blockwise prefill route, head-parallel when ``model`` divides the kv
    heads and the weights are split so, else every weight gathered and the
    heads computed whole.  A cache here is this rank's slice of positions;
    a prefill with it starts at position 0."""
    b, s, _ = x.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cdt = cfg.compute_dtype
    cross = src is not x
    grp = mp.group("model")
    if kv_cache is not None and s > 1 and cache_pos != 0:
        raise ValueError("a sharded prefill starts at cache position 0")

    if (cfg.shard_attn_batch and blockwise and not cross and window is None
            and dh in HEAD_DIMS and s % mp.m == 0):
        # each rank works on its own q rows: x, the norms and the gathered
        # weights collect the ranks' partial gradients (module sharding's
        # table)
        rows = s // mp.m
        lo = mp.r * rows
        x = mp.copy(x)
        q, k, v = _qkv(_copied_norms(p, cfg, mp), x[:, lo:lo + rows], x,
                       [mp.leaf(p, n, split=("model",))
                        for n in ("wq", "wk", "wv")], h, kv,
                       cfg, positions[lo:lo + rows], positions)
        if kv_cache is not None:
            _write_cache(kv_cache, k, v, cache_pos, mp)
        out = _context_parallel_flash(
            q.reshape(b, rows, kv, cfg.q_per_kv, dh), k, v, causal, mp)
        out = out.reshape(b, rows, h * dh).to(cdt) @ mp.leaf(
            p, "wo", split=("model",)).to(cdt)
        return sharding.gather(out, 1, grp), kv_cache

    specs = [mp.spec(n) for n in ("wq", "wk", "wv", "wo")]
    tp = (kv % mp.m == 0 and all(_ax(sp, -1) == "model" for sp in specs[:3])
          and _ax(specs[3], -2) == "model")
    col, row = ({-1: "model"}, {-2: "model"}) if tp else (None, None)
    hl, kvl = (h // mp.m, kv // mp.m) if tp else (h, kv)
    if tp:                        # this rank's heads: the inputs and norms
        src = mp.copy(src)        # collect the ranks' partial gradients
        x = mp.copy(x) if cross else src
        p = _copied_norms(p, cfg, mp)
    q, k, v = _qkv(p, x, src, [mp.leaf(p, n, col) for n in ("wq", "wk", "wv")],
                   hl, kvl, cfg,
                   *((None, None) if cross else (positions, positions)))
    if kv_cache is not None:
        every = (k, v) if not tp else (sharding.all_gather(k, 2, grp),
                                       sharding.all_gather(v, 2, grp))
        _write_cache(kv_cache, *every, cache_pos, mp)
    q = q.reshape(b, s, kvl, cfg.q_per_kv, dh)
    if blockwise:
        out = _blockwise(q, k, v, causal, window)
    elif kv_cache is None:
        out, _ = _softmax_attention(
            q, k, v, None if cross else _q_pos(positions),
            torch.arange(k.shape[1], device=x.device), window, causal, cdt)
    else:
        if tp:
            q = sharding.all_gather(q, 2, grp)
        out = _split_kv_attention(q, kv_cache, cache_pos, _q_pos(positions),
                                  window, causal, cdt, mp)
        if tp:
            out = out[:, :, mp.r * kvl:(mp.r + 1) * kvl]
    out = out.reshape(b, s, hl * dh).to(cdt) @ mp.leaf(p, "wo", row).to(cdt)
    return (_row_sum(out, mp) if tp else out), kv_cache


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


def mlp_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
              mp: ModelParallel | None = None) -> torch.Tensor:
    """The gated MLP; with ``mp`` column-parallel ``w_gate``/``w_up`` and
    row-parallel ``w_down`` summed by ``all_reduce`` when all three are
    split over ``model``, else on the gathered weights."""
    cdt = cfg.compute_dtype
    tp = mp is not None and (
        _ax(mp.spec("w_gate"), -1) == _ax(mp.spec("w_up"), -1) == "model"
        and _ax(mp.spec("w_down"), -2) == "model")
    col, row = ({-1: "model"}, {-2: "model"}) if tp else (None, None)
    if tp:
        x = mp.copy(x)
    g = F.silu(x @ _leaf(p, "w_gate", mp, col).to(cdt))
    u = x @ _leaf(p, "w_up", mp, col).to(cdt)
    y = (g * u) @ _leaf(p, "w_down", mp, row).to(cdt)
    return _row_sum(y, mp) if tp else y

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


def _moe_slots_mp(idx: torch.Tensor, mc: MoEConfig, mp: ModelParallel):
    """:func:`moe_slots` of this rank's [t, k] assignments within the whole
    batch: with the batch split, every rank's choices are all-gathered
    over the batch axes, so the capacity and the assignments that
    overflow are the one-process ones; the kept ones of this rank then
    take slots in order in a buffer of min(cap, t * k) a expert.  Returns
    (slot, keep, buffer capacity)."""
    t, k = idx.shape
    every = sharding.all_gather(idx, 0, mp.batch_group)
    _, keep_all, cap = moe_slots(every, mc)
    keep = keep_all.view(-1, k)[mp.batch_block * t:(mp.batch_block + 1) * t]
    keep = keep.reshape(-1)
    cap_l = min(cap, t * k)
    flat_e = idx.reshape(-1)
    onehot = (F.one_hot(flat_e, mc.n_experts) * keep[:, None]).t().contiguous()
    before = (onehot.cumsum(1) - onehot).gather(0, flat_e[None])[0]
    slot = torch.where(keep, flat_e * cap_l + before,
                       torch.full_like(flat_e, mc.n_experts * cap_l))
    return slot, keep, cap_l


def moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
              mp: ModelParallel | None = None):
    """Returns (out [B, S, D], aux_loss scalar).  Capacity-dropping
    dispatch: an expert takes at most ``moe_capacity(B * S)`` assignments
    and drops the rest (GShard/Switch semantics); the kept tokens are
    scattered into [E, cap, D] buffers, every expert runs its SwiGLU as
    dense batched matmuls [E, cap, D] x [E, D, F], and the results are
    gathered back, weighted by the renormalised gates and summed per token.
    The auxiliary loss is Switch's, E * sum_e f_e * p_e times
    ``router_aux_weight``, with f_e the share of tokens whose first choice
    is e.

    With ``mp``, on this rank's blocks: the routing (router, capacity,
    slots, gates, aux loss) of the whole batch on every rank
    (:func:`_moe_slots_mp`); with the experts' E over ``model`` this rank
    runs its E/P experts on their slots of the dispatch buffer and the
    gated outputs, zero for the others' experts, are summed by
    ``all_reduce``; otherwise every expert on the gathered weights.  The
    shared expert is :func:`mlp_apply`."""
    mc = cfg.moe
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    e, k = mc.n_experts, mc.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, idx = moe_route(xt, _leaf(p, "router", mp), mc)
    gate = probs.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    if mp is None or mp.batch_group is None:
        slot, keep, cap = moe_slots(idx, mc)
        ce = F.one_hot(idx[:, 0], e).float().mean(0)
        aux = e * (probs.mean(0) * ce).sum() * mc.router_aux_weight
    else:                          # the means over the whole batch
        slot, keep, cap = _moe_slots_mp(idx, mc, mp)
        sums = torch.stack([probs.sum(0),
                            F.one_hot(idx[:, 0], e).float().sum(0)])
        sums = sharding.sum_partials(sums, mp.batch_group) / (
            t * torch.distributed.get_world_size(mp.batch_group))
        aux = e * (sums[0] * sums[1]).sum() * mc.router_aux_weight

    ep = mp is not None and all(_ax(mp.spec(n), 0) == "model"
                                for n in ("w_gate", "w_up", "w_down"))
    lead = {0: "model"} if ep else None
    wg, wu, wd = (_leaf(p, n, mp, lead).to(cdt)
                  for n in ("w_gate", "w_up", "w_down"))
    el = wg.shape[0]                       # this rank's experts e0 + [0, el)
    e0 = mp.r * el if ep else 0
    w = (gate.reshape(-1) * keep).to(cdt)
    xe = xt
    if ep:                 # the dispatch and gates enter this rank's experts
        xe, w = mp.copy(xt), mp.copy(w)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = xt.new_zeros((e * cap + 1, d), dtype=cdt)
    buf = buf.index_put((slot,), xe[tok].to(cdt))      # row E*cap: dropped
    ebuf = buf[e0 * cap:(e0 + el) * cap].view(el, cap, d)
    g = F.silu(torch.bmm(ebuf, wg))
    u = torch.bmm(ebuf, wu)
    y = torch.bmm(g * u, wd).view(el * cap, d)
    # zero rows for the other ranks' experts and the dropped row
    y = torch.cat([y.new_zeros((e0 * cap, d)), y,
                   y.new_zeros(((e - e0 - el) * cap + 1, d))])
    out = (y[slot] * w[:, None]).view(t, k, d).sum(1)
    if ep:
        out = _row_sum(out, mp)
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], xt, cfg, _sub(mp, "shared"))
    return out.view(b, s, d), aux


# ---------------------------------------------------------------------------
# LM head / embedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: LMConfig) -> dict:
    p = {"tok": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype)
    return p


def embed_apply(p: dict, tokens: torch.Tensor, cfg: LMConfig,
                mp: ModelParallel | None = None) -> torch.Tensor:
    """Token rows of ``p["tok"]`` in ``compute_dtype``; with ``mp`` and the
    vocab over ``model``, each rank looks up the tokens of its vocab rows,
    zeros for the rest, summed by ``all_reduce`` (one non-zero term a
    token: exact)."""
    if mp is None:
        return p["tok"][tokens].to(cfg.compute_dtype)  # gather, then cast
    if _ax(mp.spec("tok"), 0) != "model":
        return mp.leaf(p, "tok")[tokens].to(cfg.compute_dtype)
    tok = mp.leaf(p, "tok", {0: "model"})
    n = tok.shape[0]
    local = tokens.long() - mp.r * n
    inside = (local >= 0) & (local < n)
    rows = tok[local.clamp(0, n - 1)].to(cfg.compute_dtype)
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return sharding.sum_partials(rows, mp.group("model"))


def vocab_logits(x: torch.Tensor, p: dict, key: str, vocab_dim: int,
                 cfg: LMConfig, mp: ModelParallel | None = None):
    """``x @ W`` in ``compute_dtype`` for the unembedding ``p[key]`` whose
    vocab is dim ``vocab_dim`` (0: a tied [V, D] table, used transposed;
    1: [D, V]).  With ``mp`` and the vocab over ``model`` each rank takes
    its vocab columns and the logits are all-gathered along the vocab."""
    split = mp is not None and _ax(mp.spec(key), vocab_dim) == "model"
    w = p[key] if mp is None else mp.leaf(
        p, key, {vocab_dim: "model"} if split else None)
    w = w.to(cfg.compute_dtype)
    if split:
        x = mp.copy(x)
    logits = x @ (w.T if vocab_dim == 0 else w)
    return sharding.gather(logits, -1, mp.group("model")) if split \
        else logits


def unembed_apply(p: dict, x: torch.Tensor, cfg: LMConfig,
                  mp: ModelParallel | None = None) -> torch.Tensor:
    if cfg.tie_embeddings:
        return vocab_logits(x, p, "tok", 0, cfg, mp)
    return vocab_logits(x, p, "unembed", 1, cfg, mp)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None,
                 mp: ModelParallel | None = None) -> torch.Tensor:
    """Mean cross-entropy in float32; logits [.., V], labels [..] int.

    With ``mp`` and the batch split over the batch axes, the mean over the
    global batch: every rank holds an equal share of it, so the mean is the
    ranks' local means summed (``sharding.SumPartials``) over the number
    of batch ranks (exact at one rank); a ``mask``'s sums are summed over
    the ranks before they divide."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    grp = None if mp is None else mp.batch_group
    if grp is None:
        if mask is not None:
            return (nll * mask).sum() / mask.sum().clamp_min(1)
        return nll.mean()
    if mask is not None:
        sums = sharding.sum_partials(torch.stack(
            [(nll * mask).sum(), mask.sum().to(nll.dtype)]), grp)
        return sums[0] / sums[1].clamp_min(1)
    return sharding.sum_partials(nll.mean(), grp) \
        / torch.distributed.get_world_size(grp)
