"""Named simulation environments ("scenarios") — the port's copy of
``repro.sim.scenarios`` (numpy only).

A Scenario bundles (a) how the static per-client mean resources are drawn
and (b) the round-wise dynamics layered on top of the paper's truncated-
normal fluctuation (Eqs. 8-9); ``sim/engine.py`` reads the fields in its
round loop, and :class:`ScenarioResources` plugs them into the host-loop
server (fl/server.py) exactly like ``sim/resources.ResourceModel``.  The
registry, ``build_env``/``cell_ids`` and ``ScenarioResources`` are
byte-identical to the JAX package's (tests/test_torch_scenarios.py,
tests/test_torch_host_fl.py), so a scenario name means the same
environment in both packages.

Registry:
  paper-baseline         — Sect. IV setup exactly (stationary means)
  heavy-tail-stragglers  — a fraction of clients are 10x-slower compute
                           stragglers (mixture tail on gamma_k)
  correlated-congestion  — clients share cells; each cell's throughput is
                           scaled by a per-round lognormal congestion factor
  metro-congestion       — the same dynamics at metro scale (100 cells)
  diurnal-drift          — cell throughput follows a sinusoidal day cycle
  client-churn           — each round one client may be replaced by a fresh
                           device (new mean resources, server stats go stale)
  flaky-clients          — failure injection (FaultModel): 10% crash before
                           upload, 5% mid-upload churn, 2% corrupted updates
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.sim.network import (CELL_RADIUS_M, MIN_DIST_M, NetworkEnv,
                                     place_clients_uniform_disk,
                                     throughput_bps)
from repro_torch.sim.resources import PAPER_MODEL_BITS
from repro_torch.sim.truncnorm import sample_truncated_normal

CAP_LOW, CAP_HIGH = 10.0, 100.0          # paper: gamma_k ~ U[10, 100]
DATA_LOW, DATA_HIGH = 100, 1000          # paper: D_k ~ U[100, 1000]
STRAGGLER_CAP_LOW, STRAGGLER_CAP_HIGH = 1.0, 10.0


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-round, per-client failure probabilities.

    Each dispatched client independently draws three Bernoulli outcomes per
    round: ``crash_prob`` (crash before upload), ``churn_prob`` (leaves the
    cell mid-upload) and ``corrupt_prob`` (the upload completes in time but
    the update is garbage).  All-zero (the default) switches the failure
    layer off.  Fault injection requires a finite round ``deadline``, which
    the engine validates.
    """

    crash_prob: float = 0.0
    churn_prob: float = 0.0
    corrupt_prob: float = 0.0

    def __post_init__(self):
        if any(p < 0.0 or p > 1.0 for p in self.probs):
            raise ValueError(f"fault probabilities must lie in [0, 1], "
                             f"got {self.probs}")

    @property
    def active(self) -> bool:
        return (self.crash_prob > 0.0 or self.churn_prob > 0.0
                or self.corrupt_prob > 0.0)

    @property
    def probs(self) -> tuple[float, float, float]:
        """The (crash, churn, corrupt) triple the round kernels take."""
        return (float(self.crash_prob), float(self.churn_prob),
                float(self.corrupt_prob))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative environment description (all dynamics default to off)."""

    name: str
    eta: float = 1.5                 # default fluctuation level (Eq. 8)
    straggler_frac: float = 0.0      # fraction of 10x-slower compute clients
    congestion_cells: int = 0        # >0: clients binned into this many cells
    congestion_sigma: float = 0.0    # lognormal sigma of per-cell factor
    diurnal_amp: float = 0.0         # throughput *= 1 + amp*sin(2pi r/period)
    diurnal_period: int = 0
    churn_prob: float = 0.0          # P[one client replaced] per round
    fault: FaultModel = FaultModel()  # per-client failure injection

    def build_env(self, n_clients: int, rng: np.random.Generator) -> NetworkEnv:
        """Paper Sect. IV means, with the scenario's straggler mixture."""
        dist = place_clients_uniform_disk(n_clients, rng)
        theta = throughput_bps(dist)
        gamma = rng.uniform(CAP_LOW, CAP_HIGH, size=n_clients)
        if self.straggler_frac > 0.0:
            slow = rng.uniform(size=n_clients) < self.straggler_frac
            gamma = np.where(
                slow, rng.uniform(STRAGGLER_CAP_LOW, STRAGGLER_CAP_HIGH,
                                  size=n_clients), gamma)
        d_k = rng.integers(DATA_LOW, DATA_HIGH + 1,
                           size=n_clients).astype(np.float64)
        return NetworkEnv(dist_m=dist, mean_throughput_bps=theta,
                          mean_capability=gamma, n_samples=d_k)

    def cell_ids(self, n_clients: int) -> np.ndarray:
        """Deterministic client->cell binning."""
        cells = max(self.congestion_cells, 1)
        return np.arange(n_clients) % cells

    def diurnal_multiplier(self, rnd: int | np.ndarray) -> np.ndarray:
        if self.diurnal_amp == 0.0 or self.diurnal_period <= 0:
            return np.asarray(1.0)
        m = 1.0 + self.diurnal_amp * np.sin(
            2.0 * math.pi * np.asarray(rnd, dtype=np.float64)
            / self.diurnal_period)
        return np.maximum(m, 0.05)


class ScenarioResources:
    """Round-wise (t_UD, t_UL) sampler implementing a Scenario's dynamics.

    Drop-in for ``ResourceModel`` in ``fl.server.FederatedServer``: the
    server calls ``advance()`` (dynamics step, internal rng) then
    ``sample_times(rng)`` (within-round fluctuation, server rng) each round.
    With all dynamics off this consumes the server rng identically to
    ``ResourceModel``, so paper-baseline trajectories are unchanged.
    """

    def __init__(self, scenario: Scenario, env: NetworkEnv,
                 eta: float | None = None,
                 model_bits: float = PAPER_MODEL_BITS,
                 seed: int = 0, fluctuate: bool = True):
        self.scenario = scenario
        self.env = env
        self.eta = scenario.eta if eta is None else eta
        self.model_bits = model_bits
        self.fluctuate = fluctuate
        self.mean_theta = env.mean_throughput_bps.copy()
        self.mean_gamma = env.mean_capability.copy()
        self.cell_id = scenario.cell_ids(env.n_clients)
        self._rng = np.random.default_rng(seed + 9173)
        self._round = 0
        self._cell_factor = np.ones(max(scenario.congestion_cells, 1))

    def advance(self) -> None:
        """The dynamics between rounds, from the internal rng."""
        s = self.scenario
        self._round += 1
        if s.congestion_cells > 0 and s.congestion_sigma > 0.0:
            self._cell_factor = np.exp(self._rng.normal(
                0.0, s.congestion_sigma, size=s.congestion_cells))
        if s.churn_prob > 0.0 and self._rng.uniform() < s.churn_prob:
            j = int(self._rng.integers(self.env.n_clients))
            r = max(CELL_RADIUS_M * math.sqrt(self._rng.uniform()), MIN_DIST_M)
            self.mean_theta[j] = float(throughput_bps(np.asarray(r)))
            self.mean_gamma[j] = self._rng.uniform(CAP_LOW, CAP_HIGH)

    def _effective_theta(self) -> np.ndarray:
        s = self.scenario
        theta = self.mean_theta * float(s.diurnal_multiplier(self._round))
        if s.congestion_cells > 0:
            theta = theta * self._cell_factor[self.cell_id]
        return theta

    def sample_times(self, rng: np.random.Generator
                     ) -> tuple[np.ndarray, np.ndarray]:
        """The within-round fluctuation (Eqs. 8-11) from the server rng."""
        theta_mu = self._effective_theta()
        if self.fluctuate:
            theta = sample_truncated_normal(theta_mu, self.eta, rng)
            gamma = sample_truncated_normal(self.mean_gamma, self.eta, rng)
        else:
            theta, gamma = theta_mu, self.mean_gamma
        t_ud = self.env.n_samples / np.maximum(gamma, 1e-9)
        t_ul = self.model_bits / np.maximum(theta, 1e-9)
        return t_ud, t_ul


SCENARIOS: dict[str, Scenario] = {s.name: s for s in [
    Scenario("paper-baseline"),
    Scenario("heavy-tail-stragglers", straggler_frac=0.2),
    Scenario("correlated-congestion", congestion_cells=7,
             congestion_sigma=0.5),
    Scenario("metro-congestion", congestion_cells=100,
             congestion_sigma=0.5),
    Scenario("diurnal-drift", diurnal_amp=0.5, diurnal_period=200),
    Scenario("client-churn", churn_prob=0.2),
    Scenario("flaky-clients", fault=FaultModel(
        crash_prob=0.10, churn_prob=0.05, corrupt_prob=0.02)),
]}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
