"""The paper's client-selection policies (Sect. III) in numpy — the port's
copy of ``repro.core.bandit``, the host-loop twin of the vectorised
selection in ``core/bandit.py`` (whose JAX counterpart is
``repro.core.bandit_jax``).

Implements, exactly as published:
  * Algorithm 1 (greedy set construction shared by all policies),
  * Eq. (1)  T_inc(S, k) incremental round-time estimator,
  * Eq. (4)  Naive UCB score        (policy ``naive_ucb``),
  * Eqs. (5)-(7) Element-wise UCB   (policy ``elementwise_ucb``),
  * FedCS            (last observed latency)          [paper ref 5],
  * Extended FedCS   (moving average of last 5 obs),
  * random selection, and a clairvoyant ``oracle`` (knows this round's true
    times) as an upper bound — the latter two are beyond-paper baselines.

``fl/server.FederatedServer`` drives these policies round by round.  Same
float64 arithmetic and the same ``numpy`` generator draws as the JAX
package's module, so both select the same clients
(tests/test_torch_host_fl.py holds them bitwise equal).
"""

from __future__ import annotations

import dataclasses
import numpy as np

BIG = 1e12          # finite stand-in for the "never selected" infinite UCB bonus


# ---------------------------------------------------------------------------
# Eq. (1): incremental round-time estimator, and the true round schedule.
# ---------------------------------------------------------------------------

def t_inc(t: float, t_d: float, t_ud_k: float, t_ul_k: float) -> float:
    """Eq. (1): how much the round time grows when appending client k.

    ``t``   — current estimated elapsed time (upload-pipe end),
    ``t_d`` — current Distribution-step time  T_S^d = max_{i in S} t_UL_i.
    """
    new_t_d = max(t_d, t_ul_k)
    return (new_t_d - t_d) + max(t_ud_k - (t - t_d), 0.0) + t_ul_k


def estimate_round_time(order: list[int], t_ud: np.ndarray, t_ul: np.ndarray) -> float:
    """Accumulate Eq. (1) over a client sequence (the estimator's view)."""
    t, t_d = 0.0, 0.0
    for k in order:
        t += t_inc(t, t_d, float(t_ud[k]), float(t_ul[k]))
        t_d = max(t_d, float(t_ul[k]))
    return t


def true_round_time(order: list[int], t_ud: np.ndarray, t_ul: np.ndarray) -> float:
    """Physically realized schedule: multicast distribution to *all* selected
    clients (T_d = max t_UL proxy, known once the set is fixed), parallel
    local update, then sequential scheduled upload in the given order."""
    if not order:
        return 0.0
    t_d = max(float(t_ul[k]) for k in order)
    t = t_d
    for k in order:
        t = max(t, t_d + float(t_ud[k])) + float(t_ul[k])
    return t


# ---------------------------------------------------------------------------
# Per-client statistics kept by the server.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientStats:
    """Server-side observation state over K clients (arrays of shape [K])."""

    n_sel: np.ndarray            # N_k  — times selected
    sum_ud: np.ndarray           # running sum of observed t_UD
    sum_ul: np.ndarray           # running sum of observed t_UL
    sum_tinc: np.ndarray         # running sum of observed T_inc (naive score)
    last_ud: np.ndarray          # most recent observation (FedCS; 0 = never)
    last_ul: np.ndarray
    hist_ud: np.ndarray          # [K, W] ring buffers (Extended FedCS, W=5)
    hist_ul: np.ndarray
    hist_n: np.ndarray           # valid entries in ring buffer
    total_sel: int = 0           # Sigma N_k

    @staticmethod
    def create(n_clients: int, window: int = 5) -> "ClientStats":
        z = lambda: np.zeros(n_clients, dtype=np.float64)
        return ClientStats(
            n_sel=np.zeros(n_clients, dtype=np.int64),
            sum_ud=z(), sum_ul=z(), sum_tinc=z(), last_ud=z(), last_ul=z(),
            hist_ud=np.zeros((n_clients, window), dtype=np.float64),
            hist_ul=np.zeros((n_clients, window), dtype=np.float64),
            hist_n=np.zeros(n_clients, dtype=np.int64),
        )

    # -- updates -----------------------------------------------------------
    def observe(self, k: int, t_ud: float, t_ul: float, tinc: float) -> None:
        """Record the actual times consumed by selected client k this round
        (the reward the server receives in the Scheduled Upload step)."""
        w = self.hist_ud.shape[1]
        slot = int(self.n_sel[k]) % w
        self.hist_ud[k, slot] = t_ud
        self.hist_ul[k, slot] = t_ul
        self.hist_n[k] = min(self.hist_n[k] + 1, w)
        self.n_sel[k] += 1
        self.sum_ud[k] += t_ud
        self.sum_ul[k] += t_ul
        self.sum_tinc[k] += tinc
        self.last_ud[k] = t_ud
        self.last_ul[k] = t_ul
        self.total_sel += 1

    def forget(self, k: int) -> None:
        """Elasticity: a departed client's slot is reset for a new arrival
        (count 0 => cold-start exploration, exactly the paper's first-timer
        rule of reporting 0 s)."""
        self.n_sel[k] = 0
        self.sum_ud[k] = self.sum_ul[k] = self.sum_tinc[k] = 0.0
        self.last_ud[k] = self.last_ul[k] = 0.0
        self.hist_n[k] = 0
        self.hist_ud[k] = 0.0
        self.hist_ul[k] = 0.0

    # -- derived estimates ---------------------------------------------------
    def mean_ud(self) -> np.ndarray:
        return self.sum_ud / np.maximum(self.n_sel, 1)

    def mean_ul(self) -> np.ndarray:
        return self.sum_ul / np.maximum(self.n_sel, 1)

    def mean_tinc(self) -> np.ndarray:
        return self.sum_tinc / np.maximum(self.n_sel, 1)

    def moving_avg(self) -> tuple[np.ndarray, np.ndarray]:
        n = np.maximum(self.hist_n, 1)[:, None]
        return (self.hist_ud.sum(1) / n[:, 0], self.hist_ul.sum(1) / n[:, 0])

    def ucb_bonus(self) -> np.ndarray:
        """sqrt(log(Sigma N_k) / (2 N_k)); BIG when N_k == 0 (explore first)."""
        total = max(self.total_sel, 1)
        with np.errstate(divide="ignore"):
            bonus = np.sqrt(np.log(max(total, 2)) / (2.0 * np.maximum(self.n_sel, 1)))
        return np.where(self.n_sel == 0, BIG, bonus)


# ---------------------------------------------------------------------------
# Policies: each maps (stats, candidates) -> per-client (est_ud, est_ul) or a
# direct score; Algorithm 1 greedy then builds the ordered set.
# ---------------------------------------------------------------------------

def greedy_select(
    candidates: np.ndarray,
    s_round: int,
    est_ud: np.ndarray,
    est_ul: np.ndarray,
    extra_score: np.ndarray | None = None,
) -> list[int]:
    """Algorithm 1.  f(S,k) = -T_inc(S,k) computed from the per-client
    estimates, plus an optional additive per-client score term (used by
    Naive MAB-CS, where f is the UCB score itself and T_inc is not used).

    Returns the *ordered* selected sequence (order == upload schedule).

    The elapsed-time accumulator ``t`` is clamped at 0 after each commit:
    estimated elapsed time is a physical, nonnegative quantity, and the
    clamp keeps the BIG exploration sentinel (tau = -BIG for never-selected
    clients under the element-wise amendment) from poisoning every later
    T_inc comparison — required for the float32 on-device twin
    (core/bandit.py) to agree with this float64 reference.
    """
    remaining = list(int(c) for c in candidates)
    sel: list[int] = []
    t, t_d = 0.0, 0.0
    while remaining and len(sel) < s_round:
        if extra_score is not None:
            # Naive MAB-CS: f(S,k) is the UCB score directly (Eq. 4)
            scores = [extra_score[k] for k in remaining]
        else:
            scores = [-t_inc(t, t_d, est_ud[k], est_ul[k]) for k in remaining]
        x = remaining[int(np.argmax(scores))]
        remaining.remove(x)
        t = max(t + t_inc(t, t_d, est_ud[x], est_ul[x]), 0.0)
        t_d = max(t_d, est_ul[x])
        sel.append(x)
    return sel


class Policy:
    """Base class: stateless scoring over a ClientStats snapshot."""

    name = "base"

    def __init__(self, n_clients: int, s_round: int, **kw):
        self.n_clients = n_clients
        self.s_round = s_round

    def select(self, stats: ClientStats, candidates: np.ndarray,
               rng: np.random.Generator,
               true_times: tuple[np.ndarray, np.ndarray] | None = None) -> list[int]:
        raise NotImplementedError


class FedCS(Policy):
    """Paper ref [5] adapted to uncertainty: last observed latency is the
    estimate (clients that never participated report 0 s)."""

    name = "fedcs"

    def select(self, stats, candidates, rng, true_times=None):
        return greedy_select(candidates, self.s_round, stats.last_ud, stats.last_ul)


class ExtendedFedCS(Policy):
    """Moving average of the last five observations as the estimate."""

    name = "extended_fedcs"

    def select(self, stats, candidates, rng, true_times=None):
        ud, ul = stats.moving_avg()
        return greedy_select(candidates, self.s_round, ud, ul)


class NaiveMabCS(Policy):
    """Eq. (4): f(S,k) = -mean(T_inc)/alpha + sqrt(log Sigma N / 2 N_k)."""

    name = "naive_ucb"

    def __init__(self, n_clients, s_round, alpha: float = 1000.0, **kw):
        super().__init__(n_clients, s_round)
        self.alpha = alpha

    def select(self, stats, candidates, rng, true_times=None):
        score = -stats.mean_tinc() / self.alpha + stats.ucb_bonus()
        # estimates still drive the t/T_d bookkeeping inside Algorithm 1
        return greedy_select(candidates, self.s_round,
                             stats.mean_ud(), stats.mean_ul(), extra_score=score)


class ElementwiseMabCS(Policy):
    """Eqs. (5)-(7): per-client payoffs with negative UCB amendment,
    tau = mean/beta - bonus, then f(S,k) = -T'_inc built from tau."""

    name = "elementwise_ucb"

    def __init__(self, n_clients, s_round, beta: float = 50.0, **kw):
        super().__init__(n_clients, s_round)
        self.beta = beta

    def select(self, stats, candidates, rng, true_times=None):
        bonus = stats.ucb_bonus()
        tau_ud = stats.mean_ud() / self.beta - bonus
        tau_ul = stats.mean_ul() / self.beta - bonus
        return greedy_select(candidates, self.s_round, tau_ud, tau_ul)


class RandomSelect(Policy):
    name = "random"

    def select(self, stats, candidates, rng, true_times=None):
        pick = rng.choice(candidates, size=min(self.s_round, len(candidates)),
                          replace=False)
        return [int(k) for k in pick]


class Oracle(Policy):
    """Clairvoyant: greedy on this round's *true* sampled times (upper bound)."""

    name = "oracle"

    def select(self, stats, candidates, rng, true_times=None):
        assert true_times is not None, "oracle needs the realized times"
        t_ud, t_ul = true_times
        return greedy_select(candidates, self.s_round, t_ud, t_ul)


POLICIES: dict[str, type[Policy]] = {
    p.name: p for p in
    [FedCS, ExtendedFedCS, NaiveMabCS, ElementwiseMabCS, RandomSelect, Oracle]
}


def make_policy(name: str, n_clients: int, s_round: int, **kw) -> Policy:
    if name not in POLICIES:
        # non-stationary extensions register lazily (avoid circular import)
        from repro_torch.core import nonstationary  # noqa: F401
        POLICIES.setdefault(nonstationary.DiscountedElementwiseMabCS.name,
                            nonstationary.DiscountedElementwiseMabCS)
        POLICIES.setdefault(nonstationary.SlidingWindowElementwiseMabCS.name,
                            nonstationary.SlidingWindowElementwiseMabCS)
    try:
        return POLICIES[name](n_clients, s_round, **kw)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
