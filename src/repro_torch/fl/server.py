"""FL orchestration (paper Sect. II protocol) as a discrete-event simulation
— the port's copy of ``repro.fl.server`` (``RoundRecord``, ``FLConfig``,
``FederatedServer``, ``LocalTrainer``).

Round steps: Resource Request -> Client Selection -> Distribution ->
Model Update -> Scheduled Upload -> Aggregation.  The server never sees the
true per-round resources before committing to a selection; it observes the
realized (t_UD, t_UL) of *selected* clients afterwards — that observation is
the bandit reward.

Two execution modes share the same scheduling math:
  * time-only  — the paper's elapsed-time results (Figs. 1-2, 4) without
    touching model weights; all numpy, and bitwise the JAX package's
    server on the same seed (tests/test_torch_host_fl.py);
  * training   — additionally runs real local training on each selected
    client through a ``LocalTrainer`` (fl/cnn_trainer.py,
    fl/lm_trainer.py), on the card unless the trainer was built for the
    CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from repro_torch.core.host_bandit import (ClientStats, Policy, t_inc,
                                          true_round_time)
from repro_torch.sim.resources import ResourceModel


@dataclasses.dataclass
class RoundRecord:
    rnd: int
    selected: list[int]
    round_time: float
    elapsed: float
    est_round_time: float
    true_ud: list[float]
    true_ul: list[float]


@dataclasses.dataclass
class FLConfig:
    n_clients: int = 100
    frac_request: float = 0.1          # C — fraction polled in Resource Request
    s_round: int = 5                   # clients selected per round
    n_rounds: int = 500
    deadline_s: float = math.inf       # straggler cutoff (beyond-paper; inf = paper)
    seed: int = 0


class FederatedServer:
    """Drives the protocol; pluggable selection policy and (optional) trainer."""

    def __init__(self, cfg: FLConfig, policy: Policy, resources: ResourceModel,
                 trainer: "LocalTrainer | None" = None):
        self.cfg = cfg
        self.policy = policy
        self.resources = resources
        self.trainer = trainer
        self.stats = ClientStats.create(cfg.n_clients)
        self.rng = np.random.default_rng(cfg.seed)
        self.elapsed = 0.0
        self.history: list[RoundRecord] = []
        self.failed_rounds = 0

    # ------------------------------------------------------------------
    def _resource_request(self) -> np.ndarray:
        n_req = math.ceil(self.cfg.n_clients * self.cfg.frac_request)
        # sorted so score ties break toward the lowest client index — the
        # same deterministic convention as the on-device engine (argmax /
        # top_k), keeping the host and vectorised trajectories comparable
        return np.sort(self.rng.choice(self.cfg.n_clients, size=n_req,
                                       replace=False))

    def run_round(self, rnd: int,
                  failure_mask: np.ndarray | None = None) -> RoundRecord:
        """One FL round. ``failure_mask`` (beyond-paper) marks clients that
        die mid-round: their upload never arrives; the server aggregates the
        survivors and records a timeout-penalized observation."""
        cfg = self.cfg
        candidates = self._resource_request()

        # non-stationary environments drift between rounds (beyond-paper)
        if hasattr(self.resources, "advance"):
            self.resources.advance()
        # true realized resources for this round (server cannot see these
        # until after participation)
        t_ud, t_ul = self.resources.sample_times(self.rng)

        order = self.policy.select(self.stats, candidates, self.rng,
                                   true_times=(t_ud, t_ul))
        assert len(order) <= cfg.s_round and len(set(order)) == len(order)

        # --- realized schedule & per-client observed T_inc ----------------
        est = true_round_time(order, t_ud, t_ul)
        t, t_d = 0.0, 0.0
        survivors: list[int] = []
        for k in order:
            inc = t_inc(t, t_d, float(t_ud[k]), float(t_ul[k]))
            t += inc
            t_d = max(t_d, float(t_ul[k]))
            dead = failure_mask is not None and bool(failure_mask[k])
            obs_ud, obs_ul = float(t_ud[k]), float(t_ul[k])
            if dead:
                # timeout observation: the slot is consumed, reward is the
                # deadline (or 2x the current estimate when no deadline)
                pen = cfg.deadline_s if math.isfinite(cfg.deadline_s) else 2.0 * max(est, 1.0)
                obs_ud = max(obs_ud, pen)
            else:
                survivors.append(k)
            self.stats.observe(k, obs_ud, obs_ul, inc)

        # round-level reward hook for policies with their own decayed stats
        if hasattr(self.policy, "observe_round"):
            self.policy.observe_round(order, t_ud, t_ul)

        round_time = true_round_time(order, t_ud, t_ul)
        if math.isfinite(cfg.deadline_s):
            round_time = min(round_time, cfg.deadline_s)
            # clients whose completion exceeded the deadline are dropped
            survivors = [k for k in survivors
                         if true_round_time([k], t_ud, t_ul) <= cfg.deadline_s]

        if self.trainer is not None and survivors:
            self.trainer.train_round(survivors)
        if not survivors:
            self.failed_rounds += 1

        self.elapsed += round_time
        rec = RoundRecord(rnd=rnd, selected=order, round_time=round_time,
                          elapsed=self.elapsed, est_round_time=est,
                          true_ud=[float(t_ud[k]) for k in order],
                          true_ul=[float(t_ul[k]) for k in order])
        self.history.append(rec)
        return rec

    def run(self, n_rounds: int | None = None,
            failure_prob: float = 0.0) -> list[RoundRecord]:
        n = n_rounds if n_rounds is not None else self.cfg.n_rounds
        for rnd in range(len(self.history), len(self.history) + n):
            mask = None
            if failure_prob > 0.0:
                mask = self.rng.uniform(size=self.cfg.n_clients) < failure_prob
            self.run_round(rnd, failure_mask=mask)
        return self.history


class LocalTrainer:
    """Bridges the scheduler to real model training (FedAvg).

    ``client_update(params, shard_idx) -> (new_params, n_samples)`` runs local
    SGD for one client; aggregation is weighted FedAvg over survivors.
    Kept abstract so the CNN and LM trainers (fl/cnn_trainer.py,
    fl/lm_trainer.py) plug in the same way.
    """

    def __init__(self, params: Any,
                 client_update: Callable[[Any, int, int], tuple[Any, float]],
                 aggregate: Callable[[Any, list[tuple[Any, float]]], Any]):
        self.params = params
        self._client_update = client_update
        self._aggregate = aggregate
        self.rounds_done = 0

    def train_round(self, selected: list[int]) -> None:
        results = [self._client_update(self.params, k, self.rounds_done)
                   for k in selected]
        self.params = self._aggregate(self.params, results)
        self.rounds_done += 1
