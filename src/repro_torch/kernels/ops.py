"""Routing of the port's kernels — the port of ``repro.kernels.ops``
(``bandit_round``, ``bandit_round_sampled``, ``local_topk``,
``ucb_scores``, ``fedavg_combine``, ``flash_attention``,
``rg_lru_scan``), and ``threefry``, the port's own generator kernel.

A CUDA tensor goes to the hand-written kernel (kernels/bandit_round.py,
kernels/topk_slots.py, kernels/ucb_score.py, kernels/fedavg.py,
kernels/flash_attention.py, kernels/rg_lru.py, kernels/threefry.py); a CPU
tensor goes to the plain version (kernels/ref.py).  The bandit round's
kernel updates the state in place and its plain version returns a new one:
callers use the returned state and treat the one passed in as consumed.

Attention and the RG-LRU scan are differentiable.  When grad mode is on and
an input requires a gradient, each runs through a ``torch.autograd.Function``
whose forward is the routed call above (the kernel on the card, the plain
version on the CPU) and whose backward needs no kernel of its own:

- :class:`FlashAttentionFn` recomputes the attention through its plain
  blockwise version (``kernels/ref.flash_attention_ref``, which is
  ``models/layers.flash_attention``) and differentiates that, as the JAX
  package's ``flash_attention_trainable`` does with its jnp blockwise path;
- :class:`RgLruScanFn` runs the adjoint recurrence g_t = dy_t + a_{t+1} *
  g_{t+1} as the scan itself on time-reversed inputs (the kernel on the
  card), then db = g and da_t = g_t * y_{t-1} with y_{-1} = 0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bandit_round as _cuda
from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg
from repro_torch.kernels import threefry as _threefry
from repro_torch.kernels import topk_slots as _topk
from repro_torch.kernels import ucb_score as _ucb


def bandit_round(state, cand_idx, t_ud, t_ul, rand, hyper, *, policy: str,
                 s_round: int, decay: float = 1.0,
                 fault: tuple | None = None, deadline: float | None = None,
                 fault_u=None):
    """One fused round on presampled [G, K] times; returns ``(state, sel,
    round_time)``, plus ``flags`` with the failure layer on."""
    fn = (_cuda.bandit_round_cuda if state.n_sel.is_cuda
          else _ref.bandit_round_ref)
    return fn(state, cand_idx, t_ud, t_ul, rand, hyper, policy=policy,
              s_round=s_round, decay=decay, fault=fault, deadline=deadline,
              fault_u=fault_u)


def bandit_round_sampled(state, cand_idx, u2, rand, theta_mu, gamma_mu,
                         n_samples, eta, model_bits, hyper, *, policy: str,
                         s_round: int, decay: float = 1.0,
                         fluctuate: bool = True, fault: tuple | None = None,
                         deadline: float | None = None, fault_u=None):
    """The streamed-sampling fused round (Eq. (8) times drawn at the
    candidate slice inside the round); same returns as
    :func:`bandit_round`."""
    fn = (_cuda.bandit_round_sampled_cuda if state.n_sel.is_cuda
          else _ref.bandit_round_sampled_ref)
    return fn(state, cand_idx, u2, rand, theta_mu, gamma_mu, n_samples, eta,
              model_bits, hyper, policy=policy, s_round=s_round, decay=decay,
              fluctuate=fluctuate, fault=fault, deadline=deadline,
              fault_u=fault_u)


def local_topk(score, valid, s_round: int):
    """Local top-S of each row of [..., C] scores over the ``valid``
    entries (the segmented round's per-shard ranking): ``(vals [..., S]
    f32, slots [..., S] int32)``, exhausted steps (-inf, -1)."""
    fn = _topk.local_topk_cuda if score.is_cuda else _ref.local_topk_ref
    return fn(score, valid, s_round)


def ucb_scores(sums, n_sel, total, alpha: float = 1000.0):
    """Naive-UCB score of every arm: [G, K] sums and counts, [G] totals ->
    [G, K] float32."""
    fn = _ucb.ucb_scores_cuda if sums.is_cuda else _ref.ucb_scores_ref
    return fn(sums, n_sel, total, alpha)


def fedavg_combine(stacked, weights):
    """Weighted FedAvg combine of [G, C, N] (or [C, N]) client rows with
    [G, C] (or [C]) float32 weights -> [G, N] (or [N])."""
    fn = (_fedavg.fedavg_combine_cuda if stacked.is_cuda
          else _ref.fedavg_combine_ref)
    return fn(stacked, weights)


def threefry(keys, n: int, *, offset: int = 0, row_offsets=None,
             out: str = "bits", minval: float = 0.0, maxval: float = 1.0):
    """Threefry-2x32 of [N, 2] int32 keys over n counters from ``offset``
    (contract of ``kernels/ref.threefry_ref``)."""
    fn = _threefry.threefry_cuda if keys.is_cuda else _ref.threefry_ref
    return fn(keys, n, offset=offset, row_offsets=row_offsets, out=out,
              minval=minval, maxval=maxval)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _flash_forward(q, k, v, causal: bool, q_offset: int = 0):
    if q.is_cuda:
        return _flash.flash_attention_cuda(q, k, v, causal, q_offset)
    return _ref.flash_attention_ref(q, k, v, causal, q_offset=q_offset)


def _rg_forward(a, b):
    fn = _rg.rg_lru_scan_cuda if a.is_cuda else _ref.rg_lru_ref
    return fn(a, b)


class FlashAttentionFn(torch.autograd.Function):
    """Attention forward through the kernel; backward by recomputing the
    plain blockwise attention under autograd (FlashAttention's dataflow:
    no score matrix is kept between the passes)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
            out = _ref.flash_attention_ref(q_, k_, v_, ctx.causal,
                                           q_offset=ctx.q_offset)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None, None


class RgLruScanFn(torch.autograd.Function):
    """The scan forward; backward as the scan on time-reversed inputs."""

    @staticmethod
    def forward(ctx, a, b):
        y = _rg_forward(a, b)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, y = ctx.saved_tensors
        # g_t = dy_t + a_{t+1} g_{t+1}: reversed in time this is the
        # forward recurrence with a shifted one step (a_T = 0)
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _rg_forward(a_next.flip(1).contiguous(),
                        dy.to(a.dtype).flip(1).contiguous()).flip(1)
        da = None
        if ctx.needs_input_grad[0]:
            y_prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], 1)
            da = (g.float() * y_prev.float()).to(a.dtype)
        return da, g


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """Causal (or full) GQA attention: ``q`` [B, Sq, KV, G, dh], ``k``/``v``
    [B, Skv, KV, dh] -> [B, Sq, KV, G, dh] in q's dtype, query row i at
    position ``q_offset`` + i (a causal call masks keys j > q_offset + i);
    through :class:`FlashAttentionFn` when a gradient is wanted."""
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    return _flash_forward(q, k, v, causal, q_offset)


def rg_lru_scan(a, b):
    """The RG-LRU recurrence y_t = a_t * y_{t-1} + b_t (y_{-1} = 0) over
    ``a``, ``b`` [B, T, W] -> y [B, T, W] in a's dtype, float32 carry;
    through :class:`RgLruScanFn` when a gradient is wanted."""
    if _needs_grad(a, b):
        return RgLruScanFn.apply(a, b)
    return _rg_forward(a, b)
