"""Eq. (8) truncated-normal sampling — the port of ``repro.sim.truncnorm``.

The paper resamples every client's throughput/capability each round from
N(mu=mean, sigma^2=mean^eta) truncated to [mean-sigma, mean+sigma], by
inverse-CDF over a uniform draw:

    x = mu + sigma * Phi^-1(Phi(-1) + u * (Phi(+1) - Phi(-1)))

Two backends, split at the *transform* (uniform -> sample) so callers that
manage their own random numbers share it:

  * numpy: ``truncnorm_transform_np`` (Phi^-1 via Acklam's rational
    approximation, float64) + ``sample_truncated_normal`` — a copy of the
    JAX package's numpy half;
  * torch: ``truncnorm_transform`` (Phi^-1 via :func:`erfinv`, float32), the
    counterpart of the JAX package's ``truncnorm_transform``, and
    ``sample_truncated_normal_key``, of its ``sample_truncated_normal_jax``
    (the uniforms drawn from JAX's Threefry keys, core/prng.py).

:func:`erfinv` is the single-precision polynomial of M. Giles,
"Approximating the erfinv function" (GPU Computing Gems, 2011) — the form
XLA evaluates for ``jax.scipy.special.erfinv`` on float32 — written as
separate multiplies and adds, each rounded to float32.  The CUDA bandit-round
kernel (kernels/csrc/bandit_round.cu) evaluates the same polynomial from the
coefficient tables below, which its wrapper passes in, so the plain path and
the kernel share one definition.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT2 = math.sqrt(2.0)
# truncation probabilities: alpha = -1, beta = +1 always (a = mu - sigma,
# b = mu + sigma), computed once in float64 via the exact math.erf
P_LO = 0.5 * (1.0 + math.erf(-1.0 / SQRT2))     # Phi(-1)
P_HI = 0.5 * (1.0 + math.erf(+1.0 / SQRT2))     # Phi(+1)

# Giles' single-precision erfinv: coefficients for w = -log1p(-x^2) < 5
# (evaluated at w - 2.5) and w >= 5 (evaluated at sqrt(w) - 3), highest
# degree first (Horner order)
ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


# ---------------------------------------------------------------------------
# numpy backend (copy of the JAX package's numpy half)
# ---------------------------------------------------------------------------

_ERF = np.vectorize(math.erf, otypes=[np.float64])


def phi(x: np.ndarray) -> np.ndarray:
    """Standard normal CDF via erf: Phi(x) = (1 + erf(x/sqrt(2))) / 2."""
    return 0.5 * (1.0 + _ERF(np.asarray(x, dtype=np.float64) / SQRT2))


def phi_inv(p: np.ndarray) -> np.ndarray:
    """Inverse standard normal CDF (Acklam's rational approximation).

    Max abs error ~1.15e-9 over (0,1): far below the fluctuation scale here.
    """
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    x = np.empty_like(p)

    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)

    if np.any(lo):
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if np.any(hi):
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                 ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if np.any(mid):
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
                 (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    return x


def truncnorm_transform_np(u: np.ndarray, mean: np.ndarray,
                           eta: float) -> np.ndarray:
    """Eq. (8) transform, numpy backend: uniforms ``u`` in [0, 1) to
    truncated-normal samples around ``mean`` (same shape)."""
    mean = np.asarray(mean, dtype=np.float64)
    sigma = np.sqrt(np.power(np.maximum(mean, 1e-12), eta))
    z = phi_inv(P_LO + u * (P_HI - P_LO))
    out = mean + sigma * z
    # numerical safety: clip exactly into [a, b] and keep strictly positive
    return np.clip(out, np.maximum(mean - sigma, 1e-9), mean + sigma)


def sample_truncated_normal(
    mean: np.ndarray, eta: float, rng: np.random.Generator
) -> np.ndarray:
    """Paper Eq. (8): truncated N(mu=mean, sigma^2=mean^eta) on
    [mean-sigma, mean+sigma], inverse-CDF sampled from ``rng``."""
    return truncnorm_transform_np(rng.uniform(size=np.shape(mean)), mean, eta)


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------

def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function (Giles' polynomial, see the module
    docstring); erfinv(+-1) = +-inf.  Agrees with
    ``jax.scipy.special.erfinv`` within 2 ulp on (-1, 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, ERFINV_W_LT5[0], ERFINV_W_GE5[0])
    for c_lt, c_ge in zip(ERFINV_W_LT5[1:], ERFINV_W_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def truncnorm_transform(u: torch.Tensor, mean: torch.Tensor,
                        eta) -> torch.Tensor:
    """Eq. (8) transform, torch backend: uniforms ``u`` to truncated-normal
    samples around ``mean`` (broadcastable shapes; float32).  ``eta`` is a
    float or a tensor broadcastable against ``mean`` (the engine passes the
    per-grid-point [G, 1] column)."""
    sigma = torch.sqrt(torch.pow(mean.clamp_min(1e-12), eta))
    p = P_LO + u * (P_HI - P_LO)
    z = SQRT2 * erfinv(2.0 * p - 1.0)
    out = mean + sigma * z
    return torch.clamp(out, (mean - sigma).clamp_min(1e-9), mean + sigma)


def sample_truncated_normal_key(key: torch.Tensor, mean: torch.Tensor,
                                eta) -> torch.Tensor:
    """Eq. (8) with the uniforms drawn from a key, as the JAX package's
    ``sample_truncated_normal_jax`` draws them: ``jax.random.uniform(key,
    mean.shape)``, then :func:`truncnorm_transform`.  ``key``: [..., 2],
    one key per leading row of ``mean`` [..., *shape] (a single [2] key for
    a ``mean`` of any shape); ``eta`` as in :func:`truncnorm_transform`."""
    from repro_torch.core import prng
    u = prng.uniform(key, mean.shape[key.dim() - 1:])
    return truncnorm_transform(u, mean, eta)
