"""Non-stationary client selection, beyond the paper — the port's numpy
copy of ``repro.core.nonstationary`` (the paper's stated future work:
"clients' average resource usage will fluctuate during an FL operation").

Two classic non-stationary bandit adaptations of Element-wise MAB-CS
(Garivier & Moulines, arXiv:0805.3415), for the host-loop server:

  * Discounted UCB  — statistics decay by gamma each round, so stale
    observations stop dominating when a client's mean drifts;
  * Sliding-window UCB — statistics over the last W observations only
    (the Extended-FedCS ring buffer generalized with a UCB bonus).

Plus ``DriftingResources``: an environment where per-client mean throughput
and capability follow a geometric random walk.  ``core/host_bandit.
make_policy`` registers the two policies on first use.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.host_bandit import (BIG, ClientStats, Policy,
                                          greedy_select)
from repro_torch.sim.network import NetworkEnv
from repro_torch.sim.truncnorm import sample_truncated_normal


# ---------------------------------------------------------------------------
# discounted statistics (kept alongside ClientStats by the policy itself)
# ---------------------------------------------------------------------------

class DiscountedStats:
    def __init__(self, n_clients: int, gamma: float):
        self.gamma = gamma
        self.n = np.zeros(n_clients)          # discounted selection count
        self.sum_ud = np.zeros(n_clients)
        self.sum_ul = np.zeros(n_clients)
        self.total = 0.0

    def observe_round(self, selected: list[int], t_ud, t_ul) -> None:
        self.n *= self.gamma
        self.sum_ud *= self.gamma
        self.sum_ul *= self.gamma
        self.total = self.total * self.gamma + len(selected)
        for k in selected:
            self.n[k] += 1.0
            self.sum_ud[k] += float(t_ud[k])
            self.sum_ul[k] += float(t_ul[k])

    def bonus(self) -> np.ndarray:
        eff_total = max(self.total, 2.0)
        with np.errstate(divide="ignore"):
            b = np.sqrt(np.log(eff_total) / (2.0 * np.maximum(self.n, 1e-3)))
        return np.where(self.n < 1e-2, BIG, np.minimum(b, BIG))


class DiscountedElementwiseMabCS(Policy):
    """Element-wise MAB-CS with gamma-discounted statistics."""

    name = "discounted_ucb"

    def __init__(self, n_clients, s_round, beta: float = 50.0,
                 gamma: float = 0.99, **kw):
        super().__init__(n_clients, s_round)
        self.beta = beta
        self.disc = DiscountedStats(n_clients, gamma)

    def select(self, stats: ClientStats, candidates, rng, true_times=None):
        d = self.disc
        mean_ud = d.sum_ud / np.maximum(d.n, 1e-3)
        mean_ul = d.sum_ul / np.maximum(d.n, 1e-3)
        mean_ud = np.where(d.n < 1e-2, 0.0, mean_ud)
        mean_ul = np.where(d.n < 1e-2, 0.0, mean_ul)
        bonus = d.bonus()
        tau_ud = mean_ud / self.beta - bonus
        tau_ul = mean_ul / self.beta - bonus
        return greedy_select(candidates, self.s_round, tau_ud, tau_ul)

    def observe_round(self, selected, t_ud, t_ul) -> None:
        self.disc.observe_round(selected, t_ud, t_ul)


class SlidingWindowElementwiseMabCS(Policy):
    """Element-wise MAB-CS over the last-W-observation ring buffers."""

    name = "sliding_ucb"

    def __init__(self, n_clients, s_round, beta: float = 50.0, **kw):
        super().__init__(n_clients, s_round)
        self.beta = beta

    def select(self, stats: ClientStats, candidates, rng, true_times=None):
        ud, ul = stats.moving_avg()
        bonus = stats.ucb_bonus()
        tau_ud = ud / self.beta - bonus
        tau_ul = ul / self.beta - bonus
        return greedy_select(candidates, self.s_round, tau_ud, tau_ul)


# ---------------------------------------------------------------------------
# drifting environment
# ---------------------------------------------------------------------------

class DriftingResources:
    """Per-round geometric random walk of the per-client means, on top of the
    paper's within-round truncated-normal fluctuation."""

    def __init__(self, env: NetworkEnv, eta: float, model_bits: float,
                 drift: float = 0.05, seed: int = 0):
        self.base = env
        self.eta = eta
        self.model_bits = model_bits
        self.drift = drift
        self.theta = env.mean_throughput_bps.copy()
        self.gamma_cap = env.mean_capability.copy()
        self._rng = np.random.default_rng(seed + 1234)

    def advance(self) -> None:
        self.theta *= np.exp(self._rng.normal(0.0, self.drift,
                                              self.theta.shape))
        self.gamma_cap *= np.exp(self._rng.normal(0.0, self.drift,
                                                  self.gamma_cap.shape))
        # keep within physical bounds
        np.clip(self.theta, 1e4, 8.64e6, out=self.theta)
        np.clip(self.gamma_cap, 5.0, 200.0, out=self.gamma_cap)

    def sample_times(self, rng: np.random.Generator):
        theta = sample_truncated_normal(self.theta, self.eta, rng)
        cap = sample_truncated_normal(self.gamma_cap, self.eta, rng)
        t_ud = self.base.n_samples / np.maximum(cap, 1e-9)
        t_ul = self.model_bits / np.maximum(theta, 1e-9)
        return t_ud, t_ul
