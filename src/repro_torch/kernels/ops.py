"""Routing of the port's kernels — the port of ``repro.kernels.ops``
(``bandit_round``, ``bandit_round_sampled``, ``fedavg_combine``).

A CUDA tensor goes to the hand-written kernel (kernels/bandit_round.py,
kernels/fedavg.py); a CPU tensor goes to the plain version
(kernels/ref.py).  The bandit round's kernel updates the state in place and
its plain version returns a new one: callers use the returned state and
treat the one passed in as consumed.
"""

from __future__ import annotations

from repro_torch.kernels import bandit_round as _cuda
from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels import ref as _ref


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


def fedavg_combine(stacked, weights):
    """Weighted FedAvg combine of [G, C, N] (or [C, N]) client rows with
    [G, C] (or [C]) float32 weights -> [G, N] (or [N])."""
    fn = (_fedavg.fedavg_combine_cuda if stacked.is_cuda
          else _ref.fedavg_combine_ref)
    return fn(stacked, weights)
