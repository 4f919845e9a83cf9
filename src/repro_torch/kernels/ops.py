"""Routing of the port's kernels — the port of ``repro.kernels.ops``
(``bandit_round``, ``bandit_round_sampled``, ``local_topk``,
``ucb_scores``, ``fedavg_combine``, ``flash_attention``,
``rg_lru_scan``).

A CUDA tensor goes to the hand-written kernel (kernels/bandit_round.py,
kernels/topk_slots.py, kernels/ucb_score.py, kernels/fedavg.py,
kernels/flash_attention.py, kernels/rg_lru.py); a CPU tensor goes to the
plain version (kernels/ref.py).  The bandit round's
kernel updates the state in place and its plain version returns a new one:
callers use the returned state and treat the one passed in as consumed.
"""

from __future__ import annotations

from repro_torch.kernels import bandit_round as _cuda
from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg
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


def flash_attention(q, k, v, causal: bool = True):
    """Causal (or full) GQA attention: ``q`` [B, Sq, KV, G, dh], ``k``/``v``
    [B, Skv, KV, dh] -> [B, Sq, KV, G, dh] in q's dtype."""
    fn = _flash.flash_attention_cuda if q.is_cuda else _ref.flash_attention_ref
    return fn(q, k, v, causal)


def rg_lru_scan(a, b):
    """The RG-LRU recurrence y_t = a_t * y_{t-1} + b_t (y_{-1} = 0) over
    ``a``, ``b`` [B, T, W] -> y [B, T, W] in a's dtype, float32 carry."""
    fn = _rg.rg_lru_scan_cuda if a.is_cuda else _ref.rg_lru_ref
    return fn(a, b)
