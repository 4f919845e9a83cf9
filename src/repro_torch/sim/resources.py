"""Resource fluctuation model (paper Eqs. (8)-(11)) — the port's numpy copy
of ``repro.sim.resources`` (``ResourceModel``, ``PAPER_MODEL_BYTES``,
``PAPER_MODEL_BITS``).

Each client's throughput and computational capability are re-sampled every
round from a truncated normal distribution with

    mu = mean, sigma^2 = mean^eta, a = mean - sigma, b = mean + sigma

(``sim/truncnorm.sample_truncated_normal``).  Model update and upload times
follow Eqs. (10)-(11):

    t_UD = D_k / gamma_tmp        (seconds)
    t_UL = M / theta_tmp          (M = model bits, theta in bit/s)

The host-loop server (fl/server.py) draws from the same ``numpy`` generator
as the JAX package's, so both see the same times.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.network import NetworkEnv
from repro_torch.sim.truncnorm import sample_truncated_normal

PAPER_MODEL_BYTES = 18.3e6          # 4.6M params fp32 ~= 18.3 MB
PAPER_MODEL_BITS = PAPER_MODEL_BYTES * 8


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    """Round-wise sampler of (t_UD, t_UL) for every client."""

    env: NetworkEnv
    eta: float
    model_bits: float           # M in bits (paper: 18.3 MB * 8e6)
    fluctuate: bool = True      # False => eta ignored, deterministic means

    def sample_times(self, rng: np.random.Generator
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(t_UD [K], t_UL [K]) in seconds for this round."""
        if self.fluctuate:
            theta = sample_truncated_normal(self.env.mean_throughput_bps,
                                            self.eta, rng)
            gamma = sample_truncated_normal(self.env.mean_capability,
                                            self.eta, rng)
        else:
            theta = self.env.mean_throughput_bps
            gamma = self.env.mean_capability
        t_ud = self.env.n_samples / np.maximum(gamma, 1e-9)
        t_ul = self.model_bits / np.maximum(theta, 1e-9)
        return t_ud, t_ul

    def mean_times(self) -> tuple[np.ndarray, np.ndarray]:
        t_ud = self.env.n_samples / self.env.mean_capability
        t_ul = self.model_bits / self.env.mean_throughput_bps
        return t_ud, t_ul
