"""LTE network model from the paper (Sect. IV-A) — a copy of
``repro.sim.network`` kept inside the port, so that the port imports nothing
of the JAX package.  The same ``np.random.default_rng`` gives byte-identical
arrays in both packages (tests/test_torch_scenarios.py).

Wireless communications are modeled on an LTE network with the urban channel
model defined in ITU-R M.2135-1 (UMi NLOS, hexagonal layout).  Constants match
the paper: carrier 2.5 GHz, BS antenna 11 m, client antenna 1 m, TX power
20 dBm, antenna gain 0 dBi, 10 RBs == 1.8 MHz per client per 0.5 ms slot.
Throughput follows the Shannon capacity "with a certain loss" of
Akdeniz et al. (paper ref [14]) with Delta = 1.6 and rho_max = 4.8 bit/s/Hz.

The paper reports mean/max client throughput of 1.4 / 8.6 Mbit/s; the model
below reproduces those within a few percent (tests/test_network.py checks
the JAX package's copy).
"""

from __future__ import annotations

import dataclasses
import numpy as np

# --- paper constants -------------------------------------------------------
CARRIER_GHZ = 2.5
BS_HEIGHT_M = 11.0
UE_HEIGHT_M = 1.0
TX_POWER_DBM = 20.0
ANTENNA_GAIN_DBI = 0.0
BANDWIDTH_HZ = 1.8e6          # 10 RBs x 180 kHz
SLOT_S = 0.5e-3
CELL_RADIUS_M = 2000.0
MIN_DIST_M = 10.0
SHANNON_DELTA = 1.6           # SNR loss factor (Akdeniz et al.)
RHO_MAX = 4.8                 # spectral-efficiency cap, bit/s/Hz
THERMAL_NOISE_DBM_HZ = -174.0
NOISE_FIGURE_DB = 5.0         # BS receiver noise figure
# Link-budget calibration: the paper does not publish its full link budget
# (scheduling gain, effective NF, shadowing handling).  This margin is chosen
# (bisection, tests/test_network.py) so the area-uniform 2-km disk yields the
# paper's published mean/max client throughput of 1.4 / 8.6 Mbit/s exactly.
LINK_MARGIN_DB = 17.44


def pathloss_umi_nlos_db(dist_m: np.ndarray) -> np.ndarray:
    """ITU-R M.2135-1 UMi NLOS pathloss: 36.7 log10(d) + 22.7 + 26 log10(fc)."""
    d = np.maximum(np.asarray(dist_m, dtype=np.float64), MIN_DIST_M)
    return 36.7 * np.log10(d) + 22.7 + 26.0 * np.log10(CARRIER_GHZ)


def snr_db(dist_m: np.ndarray) -> np.ndarray:
    noise_dbm = THERMAL_NOISE_DBM_HZ + 10.0 * np.log10(BANDWIDTH_HZ) + NOISE_FIGURE_DB
    rx_dbm = TX_POWER_DBM + ANTENNA_GAIN_DBI - pathloss_umi_nlos_db(dist_m)
    return rx_dbm - noise_dbm + LINK_MARGIN_DB


def spectral_efficiency(dist_m: np.ndarray) -> np.ndarray:
    """Shannon-with-loss: rho = min(log2(1 + SNR/Delta), rho_max) [bit/s/Hz]."""
    snr_lin = 10.0 ** (snr_db(dist_m) / 10.0)
    rho = np.log2(1.0 + snr_lin / SHANNON_DELTA)
    return np.minimum(rho, RHO_MAX)


def throughput_bps(dist_m: np.ndarray) -> np.ndarray:
    """Average client throughput when holding the 10-RB allocation."""
    return BANDWIDTH_HZ * spectral_efficiency(dist_m)


def place_clients_uniform_disk(n: int, rng: np.random.Generator) -> np.ndarray:
    """Uniformly distribute clients in the 2-km cell (area-uniform)."""
    r = CELL_RADIUS_M * np.sqrt(rng.uniform(size=n))
    return np.maximum(r, MIN_DIST_M)


@dataclasses.dataclass(frozen=True)
class NetworkEnv:
    """Static per-client mean resources, drawn once per simulation."""

    dist_m: np.ndarray          # [K]
    mean_throughput_bps: np.ndarray   # [K] theta_k
    mean_capability: np.ndarray       # [K] gamma_k  (samples / s)
    n_samples: np.ndarray             # [K] D_k       (local dataset size)

    @property
    def n_clients(self) -> int:
        return int(self.dist_m.shape[0])


def make_network_env(
    n_clients: int,
    rng: np.random.Generator,
    cap_low: float = 10.0,
    cap_high: float = 100.0,
    data_low: int = 100,
    data_high: int = 1000,
) -> NetworkEnv:
    """Paper Sect. IV: theta_k from the LTE model, gamma_k ~ U[10,100],
    D_k ~ U[100, 1000]."""
    dist = place_clients_uniform_disk(n_clients, rng)
    theta = throughput_bps(dist)
    gamma = rng.uniform(cap_low, cap_high, size=n_clients)
    d_k = rng.integers(data_low, data_high + 1, size=n_clients).astype(np.float64)
    return NetworkEnv(dist_m=dist, mean_throughput_bps=theta,
                      mean_capability=gamma, n_samples=d_k)
