"""The protocol sweep — the PyTorch port of ``repro.sim.engine_jax``:
flat, client-sharded (segmented) and hierarchical (cell) selection, on one
card or over the ranks of a ``torch.distributed`` process group.

``sweep`` runs the paper's experiment: a grid of policies x eta x seeds
through R protocol rounds, each round doing Resource Request -> Eq. (8)
resource draws -> policy scoring -> Algorithm 1 / top-S selection ->
realized upload schedule -> bandit ``observe``.  The JAX package ``vmap``s
one grid point over the flattened (eta x seed) axis and ``lax.scan``s over
rounds; here every tensor carries that axis as a leading [G] dimension
(grid point g = eta index * n_seeds + seed index) and the rounds are a host
loop.  The policy axis is a Python loop, as in the JAX package.

Each round is split at a seam:

  * :func:`draw_round_inputs` draws the round's random numbers —
    candidates, the Eq. (8) uniforms, the random policy's uniforms, fault
    uniforms, congestion normals, churn draws — into a :class:`RoundDraws`,
    from one of two sources: :class:`KeyStreams`, the JAX package's
    Threefry keys (core/prng.py; what ``sweep`` draws from), or a dict of
    ``torch.Generator``s (:func:`make_generators`; the learning-coupled
    sweep of fl/engine.py);
  * :func:`run_rounds` consumes those draws and runs the rounds.

``sweep`` derives its keys as ``engine_jax`` does — ``split(PRNGKey(seed),
6)`` into the candidate, theta, gamma, policy, congestion and churn roots,
each split into one key per round — and draws each stream as the JAX
package draws it, so from the same seeds it gives ``engine_jax.sweep``'s
selections and fault flags exactly and its round times within float32
rounding, with no replay.  The tests can still hand numpy-made draws to
both :func:`run_rounds` and the JAX package's round functions.

Two sampling paths, as in the JAX package: the legacy path draws every
client's times each round (presample of [G, K]) and runs the fused round on
them; the streamed path (``fast_sampling``, the default at
K >= FAST_SAMPLING_MIN_K) polls candidates by a top-k of uniforms and draws
Eq. (8) times only for the [C] candidates, inside the fused round.  On a
CUDA device every fused round is one launch of the hand-written kernel
(kernels/bandit_round.py).

Two scale-out modes sit on the streamed path.  ``shard="clients"`` splits
the bandit state into P client blocks held as a leading [P] axis and runs
the segmented round, whose score policies rank each block's candidates with
the hand-written local top-S kernel (kernels/topk_slots.py); the blocks may
sit on several ranks (distributed/sharding.py), as may the grid points
(``shard="grid"``).
``hierarchy="cells"`` selects cells first and polls candidates only inside
them, then runs the ordinary fused round.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import bandit, prng
from repro_torch.distributed import sharding
from repro_torch.kernels.ref import sample_times_candidates
from repro_torch.sim import network
from repro_torch.sim.resources import PAPER_MODEL_BITS
from repro_torch.sim.scenarios import CAP_HIGH, CAP_LOW, Scenario, get_scenario
from repro_torch.sim.truncnorm import truncnorm_transform

FAST_SAMPLING_MIN_K = 1024

# the torch.Generator streams of the learning-coupled sweep (fl/engine.py),
# each its own generator so that one policy's extra draws (the random
# policy's uniforms) do not shift another stream: every policy and eta of a
# sweep sees the same candidates and resource uniforms (common random
# numbers, as the JAX sweep's per-seed keys give).  "perm" (the clients'
# epoch orders) comes last, so the streams before it are the same whether
# or not a sweep trains a model.
STREAMS = ("cand", "time", "pol", "fault", "cong", "churn", "perm")
# the JAX package's per-seed roots, split(PRNGKey(seed), 6) in this order
# (engine_jax._run_one)
ROOTS = ("cand", "theta", "gamma", "pol", "cong", "churn")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (or left to
    the default) and is not available; the CPU runs only when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:      # name the card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_fast_sampling(fast_sampling: bool | None, n_clients: int) -> bool:
    """``fast_sampling`` None = the streamed path at K >= 1024."""
    if fast_sampling is None:
        return n_clients >= FAST_SAMPLING_MIN_K
    return bool(fast_sampling)


# ---------------------------------------------------------------------------
# Environment and Eqs. (8)-(11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnvArrays:
    """Static scenario state on the device, shared by every grid point."""

    mean_theta: torch.Tensor    # [K] mean throughput, bit/s
    mean_gamma: torch.Tensor    # [K] mean capability, samples/s
    n_samples: torch.Tensor     # [K] local dataset sizes D_k
    cell_id: torch.Tensor       # [K] int64 congestion-cell assignment

    @staticmethod
    def from_scenario(scenario: Scenario, env, device="cpu") -> "EnvArrays":
        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return EnvArrays(
            mean_theta=f(env.mean_throughput_bps),
            mean_gamma=f(env.mean_capability),
            n_samples=f(env.n_samples),
            cell_id=torch.as_tensor(scenario.cell_ids(env.n_clients),
                                    dtype=torch.int64, device=device))


def sample_times(n_samples, theta_mu, gamma_mu, eta, model_bits, u_theta,
                 u_gamma, *, fluctuate: bool = True):
    """Eqs. (8)-(11) for every client: ([G, K] t_UD, [G, K] t_UL) from the
    [G, K] means and the round's [G, K] uniforms (``eta``: [G])."""
    if fluctuate:
        eta = eta.view(-1, 1)
        theta = truncnorm_transform(u_theta, theta_mu, eta)
        gamma = truncnorm_transform(u_gamma, gamma_mu, eta)
    else:
        theta, gamma = theta_mu, gamma_mu
    return (n_samples / gamma.clamp_min(1e-9),
            bandit.fdiv(model_bits, theta.clamp_min(1e-9)))


def throughput_bps(dist_m: torch.Tensor) -> torch.Tensor:
    """float32 LTE link budget of sim/network.py::throughput_bps."""
    d = dist_m.clamp_min(network.MIN_DIST_M)
    pl_db = (36.7 * torch.log10(d) + 22.7
             + 26.0 * math.log10(network.CARRIER_GHZ))
    noise_dbm = (network.THERMAL_NOISE_DBM_HZ
                 + 10.0 * math.log10(network.BANDWIDTH_HZ)
                 + network.NOISE_FIGURE_DB)
    snr_db = (network.TX_POWER_DBM + network.ANTENNA_GAIN_DBI - pl_db
              - noise_dbm + network.LINK_MARGIN_DB)
    rho = torch.log2(1.0 + 10.0 ** (snr_db / 10.0) / network.SHANNON_DELTA)
    return network.BANDWIDTH_HZ * rho.clamp_max(network.RHO_MAX)


# glibc's float sin (sysdeps/ieee754/flt-32/s_sinf.c), the function XLA:CPU
# calls for a float32 sin: pi/2 and 2/pi, and the polynomial coefficients of
# cos (c0..c4) and sin (s1..s3) on the reduced argument
_SINF_HPI_INV = float.fromhex("0x1.45F306DC9C883p-1")
_SINF_HPI = float.fromhex("0x1.921FB54442D18p0")
_SINF_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
           float.fromhex("0x1.55553e1068f19p-5"),
           float.fromhex("-0x1.6c087e89a359dp-10"),
           float.fromhex("0x1.99343027bf8c3p-16"))
_SINF_S = (float.fromhex("-0x1.555545995a603p-3"),
           float.fromhex("0x1.1107605230bc4p-7"),
           float.fromhex("-0x1.994eb3774cf24p-13"))


def sinf(x: torch.Tensor) -> torch.Tensor:
    """float32 sin computed as glibc's ``sinf`` computes it: the argument
    reduced by pi/2 in float64, a float64 polynomial, one rounding to
    float32.  ``torch.sin`` (SLEEF on the CPU, CUDA's ``sinf`` on the card)
    differs from it, and from each other, by an ulp on some inputs; this is
    the same float64 arithmetic on either device, so the card, the CPU and
    the JAX package on the CPU agree bitwise.  For |x| >= 120 glibc reduces
    with more bits of pi than one float64; there this function can differ
    from it by an ulp."""
    xd = x.double()
    n = torch.floor(xd * _SINF_HPI_INV + 0.5)
    r = xd - n * _SINF_HPI
    quad = n - 4.0 * torch.floor(n * 0.25)          # n mod 4
    r2 = r * r
    xs = torch.where(quad == 2, -r, r)
    c0, c1, c2, c3, c4 = _SINF_C
    s1, s2, s3 = _SINF_S
    x3 = xs * r2
    sin_p = (xs + x3 * s1) + (x3 * r2) * (s2 + r2 * s3)
    x4 = r2 * r2
    cos_p = ((c0 + r2 * c1) + x4 * c2) + (x4 * r2) * (c3 + r2 * c4)
    cos_p = torch.where(quad == 3, -cos_p, cos_p)
    out = torch.where((quad == 1) | (quad == 3), cos_p, sin_p).float()
    return torch.where(x.abs() < 2.0 ** -12, x, out)


def scenario_diurnal_mult(scen: Scenario, rounds: torch.Tensor) -> torch.Tensor:
    """Per-round diurnal throughput multiplier (1.0 without diurnal drift);
    ``rounds``: 1-based round indices.  The angle divides through ``fdiv``
    (one IEEE rounding, as XLA) and the sine is :func:`sinf`, so the
    multiplier is bitwise the JAX package's on the CPU and on the card."""
    rounds = rounds.float()
    if scen.diurnal_amp > 0.0 and scen.diurnal_period > 0:
        angle = bandit.fdiv(2.0 * math.pi * rounds, scen.diurnal_period)
        return (1.0 + scen.diurnal_amp * sinf(angle)).clamp_min(0.05)
    return torch.ones_like(rounds)


def scenario_thr_mult(scen: Scenario, cell_id: torch.Tensor,
                      normals: torch.Tensor | None, rnd: int,
                      diurnal: torch.Tensor | None = None):
    """Round ``rnd``'s (1-based) multiplier on mean throughput: diurnal
    drift times correlated cell congestion, from the round's [G, cells]
    standard normals.  Broadcastable against [G, K]; None when the
    scenario has neither.  ``diurnal``: the diurnal multipliers of rounds
    1..n (n >= ``rnd``) made beforehand, so that the round indexes them
    instead of computing its own."""
    mult = None
    if scen.diurnal_amp > 0.0 and scen.diurnal_period > 0:
        mult = (diurnal[rnd - 1] if diurnal is not None
                else scenario_diurnal_mult(
                    scen, torch.tensor([rnd], device=cell_id.device))
                ).view(1, 1)
    if normals is not None:
        cell_f = torch.exp(scen.congestion_sigma * normals)[:, cell_id]
        mult = cell_f if mult is None else mult * cell_f
    return mult


def churn_step(u: torch.Tensor, mean_theta: torch.Tensor,
               mean_gamma: torch.Tensor, churn_prob: float,
               k: int | None = None, first: int = 0):
    """Maybe replace one client per grid point with a fresh device (new
    mean resources; the server's statistics go stale).  ``u``: [G, 4]
    uniforms (whether, which client, its distance, its capability).  The
    means may be a block of the K clients (``k``, default their width),
    global clients [first, first + width)."""
    width = mean_theta.shape[1]
    k = width if k is None else k
    do = u[:, 0] < churn_prob
    j = (u[:, 1] * k).long().clamp_max(k - 1)
    r = (network.CELL_RADIUS_M * torch.sqrt(u[:, 2])).clamp_min(
        network.MIN_DIST_M)
    hit = do[:, None] & (torch.arange(first, first + width, device=u.device)[
        None] == j[:, None])
    # jax.random.uniform's minval + u * (maxval - minval), rounded once as
    # XLA contracts it, then at least minval
    new_gamma = torch.addcmul(torch.full_like(u[:, 3], CAP_LOW), u[:, 3],
                              torch.full_like(u[:, 3], CAP_HIGH - CAP_LOW)
                              ).clamp_min(CAP_LOW)
    return (torch.where(hit, throughput_bps(r)[:, None], mean_theta),
            torch.where(hit, new_gamma[:, None], mean_gamma))


# ---------------------------------------------------------------------------
# The seam: per-round draws and the round runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundDraws:
    """One round's random inputs for the [G] grid."""

    cand: torch.Tensor | None           # [G, C] int32 sorted candidates
    u_time: torch.Tensor | None         # [G, 2, K] legacy | [G, 2, C] fast
    rand: torch.Tensor | None = None    # [G, K] random policy's uniforms
    fault_u: torch.Tensor | None = None  # [G, 3, S] crash/churn/corrupt
    cong: torch.Tensor | None = None    # [G, cells] standard normals
    churn: torch.Tensor | None = None   # [G, 4] churn uniforms
    # hierarchical rounds (cand is None then): the per selected cell's
    # uniforms [G, s_cells, m] (m = ceil(K / n_cells)) from which the round
    # polls its candidates, or the round's candidate keys [G, 2] from which
    # it draws them once it has selected its cells
    cell_u: torch.Tensor | None = None
    cell_key: torch.Tensor | None = None


def make_generators(seeds, device) -> dict[str, torch.Generator]:
    """One ``torch.Generator`` per stream of :data:`STREAMS`, seeded from
    the sweep's seed list."""
    children = np.random.SeedSequence([int(s) for s in seeds]).spawn(
        len(STREAMS))
    gens = {}
    for name, child in zip(STREAMS, children):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(child.generate_state(1)[0]))
        gens[name] = gen
    return gens


def topk_lowest(u: torch.Tensor, n: int, first: int = 0,
                group=None) -> torch.Tensor:
    """Indices of the ``n`` largest entries of each row of the non-negative
    float32 ``u`` (uniforms), ties going to the lower index (the set
    ``lax.top_k`` takes), sorted ascending, int64.  ``torch.topk`` alone
    leaves the order of ties unspecified, and float32 uniforms tie at rank
    ``n`` often enough at large K to decide membership; the unique keys of
    ``bandit.rank_keys`` do not tie.

    With a process group ``group``, ``u`` is this rank's columns [first,
    first + width) of each row, the group's ranks holding the rest in
    rank order: each rank keeps the keys of its slice's top n (with the
    indices global), the ranks all-gather them, and the top n of those
    are the whole row's, bitwise."""
    keys = bandit.rank_keys(u, nonnegative=True)
    if group is None:                                   # whole rows
        return keys.topk(n, dim=-1, sorted=False).indices.sort(dim=-1).values
    top = (keys - first).topk(min(n, u.shape[-1]), dim=-1,
                              sorted=False).values
    top = sharding.gather_shards(top, 1, group).topk(
        n, dim=-1, sorted=False).values
    return (0xFFFFFFFF - (top & 0xFFFFFFFF)).sort(dim=-1).values


class _GeneratorStreams:
    """A round's draws from the ``torch.Generator``s of
    :func:`make_generators`, ``n`` rows (seeds) at a time; the round index
    is not needed, each generator runs on."""

    def __init__(self, gens: dict[str, torch.Generator], n: int):
        self.gens, self.n = gens, n

    def _rand(self, name, *shape):
        gen = self.gens[name]
        return torch.rand((self.n, *shape), generator=gen, device=gen.device)

    def candidates(self, rnd, k, n_req, fast):
        u = self._rand("cand", k)
        return (topk_lowest(u, n_req) if fast else
                u.argsort(dim=1)[:, :n_req].sort(dim=1).values).to(
                    torch.int32)

    def cells(self, rnd, s_cells, m):
        return self._rand("cand", s_cells, m), None

    def times(self, rnd, k, n_req, fast):
        return self._rand("time", 2, n_req if fast else k)

    def policy_uniforms(self, rnd, k):
        return self._rand("pol", k)

    def fault(self, rnd, s_round):
        return self._rand("fault", 3, s_round)

    def normals(self, rnd, cells):
        gen = self.gens["cong"]
        return torch.randn((self.n, cells), generator=gen, device=gen.device)

    def churn(self, rnd, k):
        return self._rand("churn", 4)


class KeyStreams:
    """The JAX package's random streams of a sweep, on Threefry keys
    (core/prng.py): the draw source of :func:`draw_round_inputs` that gives
    ``engine_jax.sweep``'s numbers from the seeds alone.

    Each seed's key splits into the roots of :data:`ROOTS`, each root into
    one key per round (``engine_jax._per_round_keys``), and each stream
    draws from its round key as the JAX package draws it:

      * candidates: ``sort(permutation(k, K)[:n_req])`` on the legacy path,
        the top ``n_req`` of ``uniform(k, (K,))`` (ties to the lower index)
        on the streamed one;
      * Eq. (8) uniforms: ``uniform`` over [K] from the theta and the gamma
        key (legacy), or one [2, C] block from the theta key (streamed);
      * the random policy's ``uniform(k, (K,))`` and the fault uniforms
        (``bandit.fault_uniforms``) from the policy key;
      * the congestion normals ``normal(k, (cells,))``;
      * churn: ``split(k, 4)`` -> the uniform whether, the ``randint``
        victim j, the uniforms of its distance and capability; j is handed
        on as the uniform (j + 0.5) / K, which ``churn_step``'s
        floor(u * K) maps back to j.

    ``seeds``: the seeds this process draws for; ``rows``: [G'] int64
    index of the seed of each grid row it runs, on the device (None: one
    row per seed).  A draw is made once per seed and then spread to the
    rows.  The keys of every stream and the small per-round streams (fault
    uniforms, congestion normals, churn draws, the permutation's sort keys'
    keys) are drawn for ``chunk`` rounds at once (default: the whole run,
    drawn once for every policy), one launch per stream; the K-sized
    streams are drawn round by round.

    ``clients`` = (first, width): draw the candidate and the random
    policy's uniforms only at clients [first, first + width) (their
    counters of the flat draw); the ranks of ``group`` hold the other
    slices, and their top-n_req candidate keys merge across them
    (:func:`topk_lowest`).

    ``drawn``: the random values drawn so far, by stream (``"keys"``
    counts key words).
    """

    def __init__(self, seeds, n_rounds: int, device, *, rows=None,
                 chunk: int | None = None, clients=None, group=None):
        self.n_rounds = int(n_rounds)
        self.chunk = self.n_rounds if chunk is None else int(chunk)
        self.rows, self.clients, self.group = rows, clients, group
        self.roots = prng.split(prng.prng_key(tuple(int(s) for s in seeds),
                                              device=device), len(ROOTS))
        self.drawn = dict.fromkeys(("keys", "cand", "time", "pol", "fault",
                                    "cong", "churn"), 0)
        self._tables: dict[str, tuple[int, torch.Tensor]] = {}

    def _count(self, name: str, x: torch.Tensor) -> torch.Tensor:
        self.drawn[name] += x.numel()
        return x

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rows is None else x.index_select(0, self.rows)

    def _table(self, name: str, rnd: int, make) -> torch.Tensor:
        """Round ``rnd``'s entry of stream ``name``'s table for the chunk
        holding it: ``make(keys)`` of the chunk's round keys [S, c, 6, 2]
        -> [S, c, ...], made when the chunk is first asked for and kept
        round-major, so that a round's entry is contiguous (the kernels
        take contiguous tensors)."""
        c0 = rnd - rnd % self.chunk
        hit = self._tables.get(name)
        if hit is None or hit[0] != c0:
            table = make(self._chunk_keys(c0))
            hit = (c0, table.transpose(0, 1).contiguous())
            self._tables[name] = hit
        return hit[1][rnd - c0]

    def _chunk_keys(self, c0: int) -> torch.Tensor:
        hit = self._tables.get("keys")
        if hit is None or hit[0] != c0:
            c = min(self.chunk, self.n_rounds - c0)
            keys = self._count("keys", prng.split(self.roots, c, offset=c0))
            hit = (c0, keys.transpose(1, 2))            # [S, c, 6, 2]
            self._tables["keys"] = hit
        return hit[1]

    def key(self, name: str, rnd: int) -> torch.Tensor:
        """[S, 2] round ``rnd``'s key of root ``name``."""
        c0 = rnd - rnd % self.chunk
        return self._chunk_keys(c0)[:, rnd - c0, ROOTS.index(name)]

    def _slice(self, k: int) -> tuple[int, int]:
        return self.clients or (0, k)

    def candidates(self, rnd, k, n_req, fast):
        if fast:
            first, width = self._slice(k)
            u = self._count("cand", prng.uniform(self.key("cand", rnd), width,
                                                 offset=first))
            return self._rows(topk_lowest(u, n_req, first, self.group).to(
                torch.int32))
        i = ROOTS.index("cand")
        subs = self._table("perm", rnd, lambda keys: self._count(
            "keys", prng.shuffle_keys(keys[:, :, i], k)))
        self.drawn["cand"] += subs[..., 0].numel() * k
        perm = prng.permute(subs, k)[:, :n_req]
        return self._rows(perm.sort(dim=1).values.to(torch.int32))

    def cells(self, rnd, s_cells, m):
        return None, self._rows(self.key("cand", rnd))

    def times(self, rnd, k, n_req, fast):
        if fast:
            u = prng.uniform(self.key("theta", rnd), 2 * n_req).view(
                -1, 2, n_req)
        else:
            u = prng.uniform(torch.stack([self.key("theta", rnd),
                                          self.key("gamma", rnd)], 1), k)
        return self._rows(self._count("time", u))

    def policy_uniforms(self, rnd, k):
        first, width = self._slice(k)
        return self._rows(self._count("pol", bandit.random_uniforms(
            self.key("pol", rnd), k, first, width)))

    def fault(self, rnd, s_round):
        i = ROOTS.index("pol")
        return self._rows(self._table("fault", rnd, lambda keys: self._count(
            "fault", bandit.fault_uniforms(keys[:, :, i], s_round))))

    def normals(self, rnd, cells):
        i = ROOTS.index("cong")
        return self._rows(self._table("cong", rnd, lambda keys: self._count(
            "cong", prng.normal(keys[:, :, i], cells))))

    def churn(self, rnd, k):
        if k > 1 << 22:
            raise ValueError(f"K={k}: the churn victim's (j + 0.5) / K is "
                             f"exact up to K = 2^22")
        i = ROOTS.index("churn")
        return self._rows(self._table("churn", rnd, lambda keys: self._count(
            "churn", churn_draws(keys[:, :, i], k))))


def churn_draws(key: torch.Tensor, k: int) -> torch.Tensor:
    """``engine_jax.churn_step``'s draws from its round keys [..., 2] as
    :func:`churn_step`'s [..., 4] uniforms: whether (``uniform(k1)``), the
    victim ``randint(k2, (), 0, K)`` as (j + 0.5) / K, and the uniforms of
    the new device's distance (k3) and capability (k4)."""
    sub = prng.split(key, 4)
    u = prng.uniform(sub[..., [0, 2, 3], :])
    j = prng.randint(sub[..., 1, :], (), 0, k)
    return torch.stack([u[..., 0], (j.float() + 0.5) / k, u[..., 1],
                        u[..., 2]], -1)


def draw_round_inputs(streams, *, n_seeds: int | None = None,
                      n_etas: int = 1, rnd: int = 0, k: int, n_req: int,
                      s_round: int, fast: bool, fluctuate: bool, policy: str,
                      scen: Scenario, fault,
                      cells: tuple[int, int] | None = None) -> RoundDraws:
    """Draw round ``rnd``'s (0-based) inputs and repeat them over the eta
    axis ``n_etas`` times.  ``streams``: a :class:`KeyStreams` (its rows;
    ``rnd`` picks the round's keys), or a dict of ``torch.Generator``s
    (:func:`make_generators`; ``n_seeds`` rows, each generator running
    on).  Candidates: a sorted permutation prefix (legacy path) or the
    sorted top-``n_req`` of K uniforms (streamed path) — both a uniform
    random ``n_req``-subset.  With ``cells`` = (s_cells, m) the round is
    hierarchical: instead of candidates it draws ``cell_u``, m uniforms for
    each of the s_cells cells the round will select, or with keys
    ``cell_key``, the round's candidate keys (``n_req`` is then the round's
    candidate count)."""
    src = (streams if isinstance(streams, KeyStreams)
           else _GeneratorStreams(streams, n_seeds))
    cand = cell_u = cell_key = None
    if cells is not None:
        cell_u, cell_key = src.cells(rnd, *cells)
    else:
        cand = src.candidates(rnd, k, n_req, fast)
    d = RoundDraws(
        cand=cand, cell_u=cell_u, cell_key=cell_key,
        u_time=src.times(rnd, k, n_req, fast) if fluctuate else None,
        rand=src.policy_uniforms(rnd, k) if policy == "random" else None,
        fault_u=src.fault(rnd, s_round) if fault is not None else None,
        cong=(src.normals(rnd, scen.congestion_cells)
              if scen.congestion_cells > 0 and scen.congestion_sigma > 0.0
              else None),
        churn=src.churn(rnd, k) if scen.churn_prob > 0.0 else None)
    if n_etas == 1:
        return d
    return RoundDraws(**{
        f.name: (None if (x := getattr(d, f.name)) is None
                 else x.repeat(n_etas, *([1] * (x.dim() - 1))))
        for f in dataclasses.fields(d)})


def take_rows(d: RoundDraws, rows: torch.Tensor) -> RoundDraws:
    """The draws of grid rows ``rows`` (indices into ``d``'s leading
    axis)."""
    return RoundDraws(**{
        f.name: None if (x := getattr(d, f.name)) is None
        else x.index_select(0, rows) for f in dataclasses.fields(d)})


def check_chunk_rounds(n_rounds: int, chunk_rounds: int | None) -> None:
    """``chunk_rounds`` must divide ``n_rounds``, as in the JAX package."""
    if chunk_rounds is not None and (int(chunk_rounds) < 1
                                     or n_rounds % int(chunk_rounds)):
        raise ValueError(f"n_rounds={n_rounds} not divisible by "
                         f"chunk_rounds={chunk_rounds}")


def _uniforms(d: RoundDraws):
    """The legacy path's (theta, gamma) uniforms of a round, [G, K] each."""
    return (None, None) if d.u_time is None else (d.u_time[:, 0],
                                                  d.u_time[:, 1])


class RoundRunner:
    """The protocol rounds of one policy for the [G] grid of ``eta``: holds
    the bandit state and the (churning) mean resources between rounds.

    ``fused`` runs each round through the fused round (the CUDA kernel on
    the card); ``fused=False`` through the unfused mask pipeline.  ``fast``
    picks the streamed path, where ``u_time`` holds candidate-slice
    uniforms.  ``deadline`` switches on the failure layer, the scenario's
    FaultModel giving the fault probabilities.

    ``shards`` = P or a ``sharding.ShardGroup`` (streamed and fused only)
    runs the client-sharded segmented round
    (``bandit.make_segmented_round_fn``) on a state split into P client
    blocks; the runner holds only its process's P/R blocks (state, means
    and the environment's per-client arrays), global clients from
    ``first`` on; the draws' ``rand`` is the flat [G, K] stream or this
    process's columns of it.  ``cells`` = (s_cells, n_req_cell) (streamed
    only) runs the hierarchical rounds: each round first selects
    ``s_cells`` cells of the scenario's ``congestion_cells`` from the cell
    aggregates, polls ``n_req_cell`` candidates in each from the draws'
    ``cell_u`` (or from uniforms drawn from ``cell_key`` for the selected
    cells) and afterwards folds the observed T_inc into the aggregates.
    """

    def __init__(self, env: EnvArrays, eta: torch.Tensor, *, policy: str,
                 scen: Scenario, s_round: int, hyper: float,
                 model_bits: float, fluctuate: bool = True,
                 fast: bool = False, fused: bool = True,
                 deadline: float | None = None, shards=None,
                 cells: tuple[int, int] | None = None):
        g, k = eta.shape[0], env.mean_theta.shape[0]
        self.k, self.first = k, 0
        self.shards = None if not shards else sharding.as_group(shards)
        if self.shards:
            sg, kb = self.shards, k // self.shards.n_shards
            self.first = sg.first * kb
            end = self.first + sg.per_rank * kb
            env = EnvArrays(**{f.name: getattr(env, f.name)[self.first:end]
                               for f in dataclasses.fields(env)})
        self.env, self.eta, self.scen = env, eta, scen
        self.policy, self.s_round, self.hyper = policy, s_round, hyper
        self.model_bits, self.fluctuate = model_bits, fluctuate
        self.fast, self.fused, self.deadline = fast, fused, deadline
        self.cells = cells
        if (shards or cells) and not fast:
            raise ValueError("client-sharded and hierarchical rounds run on "
                             "the streamed-sampling path (fast=True)")
        if shards and not fused:
            raise ValueError("client-sharded rounds are fused rounds")
        self.fault = bandit.resolve_fault(scen.fault, deadline)
        self.decay = bandit.policy_decay(policy)
        width = env.mean_theta.shape[0]
        self.state = bandit.BanditState.create(g, width,
                                               device=env.mean_theta.device)
        self.m_theta = env.mean_theta.expand(g, width).contiguous()
        self.m_gamma = env.mean_gamma.expand(g, width).contiguous()
        if shards:
            self.state = sharding.shard_state(self.state,
                                              self.shards.per_rank)
            self._fn = bandit.make_segmented_round_fn(
                policy, s_round, n_shards=self.shards.n_shards,
                fluctuate=fluctuate, fault=self.fault, deadline=deadline,
                group=self.shards.group)
        elif fused and fast:
            self._fn = bandit.make_sampled_round_fn(
                policy, s_round, fluctuate=fluctuate, fault=self.fault,
                deadline=deadline)
        elif fused:
            self._fn = bandit.make_round_fn(policy, s_round, fault=self.fault,
                                            deadline=deadline)
        if cells:
            self.n_cells = int(scen.congestion_cells)
            z = torch.zeros((g, self.n_cells), device=env.mean_theta.device)
            self.cell_n, self.cell_tinc = z, z.clone()
        self._diurnal = torch.empty(0, device=env.mean_theta.device)

    def _diurnal_table(self, rnd: int) -> torch.Tensor:
        """The diurnal multipliers of rounds 1..n with n >= ``rnd``, made
        for twice as many rounds whenever a round outgrows them: the
        multiplier is elementwise, so the table holds the same bits as a
        per-round call, at a handful of calls per sweep."""
        if rnd > self._diurnal.shape[0]:
            n = max(64, 2 * rnd)
            self._diurnal = scenario_diurnal_mult(self.scen, torch.arange(
                1, n + 1, device=self._diurnal.device))
        return self._diurnal

    def flat_state(self) -> bandit.BanditState:
        """The bandit state in the flat [G, K] layout; with client shards
        over ranks, this process's clients only ([G, K*(P/R)/P])."""
        if self.shards:
            return sharding.unshard_state(self.state, self.shards.per_rank)
        return self.state

    def step(self, rnd: int, d: RoundDraws):
        """Round ``rnd`` (1-based) on the draws ``d``.  Returns ``(sel [G, S],
        round_time [G], flags [G, S] or None)``."""
        env, eta, k = self.env, self.eta, self.k
        if self.cells:
            s_cells, n_req_cell = self.cells
            cells_sel = bandit.select_cells(self.cell_n, self.cell_tinc,
                                            s_cells)
            u = (d.cell_u if d.cell_u is not None else
                 bandit.hier_cell_uniforms(d.cell_key, cells_sel,
                                           -(-k // self.n_cells)))
            d = dataclasses.replace(d, cand=bandit.hier_cand_idx(
                u, cells_sel, k, self.n_cells, n_req_cell))
            pre_tinc = self.state.sum_tinc.clone()   # the kernel updates it
        mult = scenario_thr_mult(self.scen, env.cell_id, d.cong, rnd,
                                 self._diurnal_table(rnd))
        mu_t = self.m_theta if mult is None else self.m_theta * mult
        m_gamma, bits = self.m_gamma, self.model_bits
        if self.shards:
            p = self.shards.per_rank
            rand = d.rand
            if rand is not None and rand.shape[-1] == k:   # the flat stream
                rand = rand[:, self.first:self.first + env.n_samples.shape[0]]
            out = self._fn(self.state, d.cand, d.u_time,
                           None if rand is None
                           else sharding.shard_leading(rand, p, 1),
                           sharding.shard_leading(mu_t, p, 1),
                           sharding.shard_leading(m_gamma, p, 1),
                           sharding.shard_leading(env.n_samples, p, 0), eta,
                           bits, self.hyper, fault_u=d.fault_u)
        elif self.fast and self.fused:
            out = self._fn(self.state, d.cand, d.u_time, d.rand, mu_t,
                           m_gamma, env.n_samples, eta, bits, self.hyper,
                           fault_u=d.fault_u)
        elif self.fused:
            t_ud, t_ul = sample_times(env.n_samples, mu_t, m_gamma, eta, bits,
                                      *_uniforms(d), fluctuate=self.fluctuate)
            out = self._fn(self.state, d.cand, t_ud, t_ul, d.rand, self.hyper,
                           fault_u=d.fault_u)
        else:
            if self.fast:
                t_ud, t_ul, mask = bandit.scatter_cand_times(
                    d.cand, *sample_times_candidates(
                        d.u_time, d.cand, env.n_samples, mu_t, m_gamma, eta,
                        bits, fluctuate=self.fluctuate), k)
            else:
                t_ud, t_ul = sample_times(env.n_samples, mu_t, m_gamma, eta,
                                          bits, *_uniforms(d),
                                          fluctuate=self.fluctuate)
                mask = bandit.cand_mask(d.cand, k)
            out = bandit.round_via_mask(
                self.state, mask, t_ud, t_ul, d.rand, self.hyper,
                policy=self.policy, s_round=self.s_round, decay=self.decay,
                fault=self.fault, deadline=self.deadline, fault_u=d.fault_u)
        self.state = out[0]
        if self.cells:
            self.cell_n, self.cell_tinc = bandit.update_cell_stats(
                self.cell_n, self.cell_tinc, out[1], pre_tinc,
                self.state.sum_tinc, env.cell_id, self.n_cells)
        if self.scen.churn_prob > 0.0:
            self.m_theta, self.m_gamma = churn_step(
                d.churn, self.m_theta, m_gamma, self.scen.churn_prob,
                k=self.k, first=self.first)
        return out[1], out[2], (out[3] if self.deadline is not None
                                else None)


def run_rounds(env: EnvArrays, eta: torch.Tensor,
               draws: Iterable[RoundDraws], *, policy: str, scen: Scenario,
               s_round: int, hyper: float, model_bits: float,
               fluctuate: bool = True, fast: bool = False,
               fused: bool = True, deadline: float | None = None,
               shards=None, cells: tuple[int, int] | None = None):
    """Run one round per element of ``draws`` for the [G] grid of ``eta``
    (arguments as :class:`RoundRunner`'s).

    Returns ``(round_times [G, R], flags [G, R, S] or None, state)``;
    ``flags`` exist when the failure layer is on (``deadline`` set); the
    state is in the flat [G, K] layout (``RoundRunner.flat_state``).
    """
    runner = RoundRunner(env, eta, policy=policy, scen=scen, s_round=s_round,
                         hyper=hyper, model_bits=model_bits,
                         fluctuate=fluctuate, fast=fast, fused=fused,
                         deadline=deadline, shards=shards, cells=cells)
    rts, flags = [], []
    for rnd, d in enumerate(draws, start=1):
        _, rt, fl = runner.step(rnd, d)
        rts.append(rt)
        flags.append(fl)
    failure = deadline is not None
    return (torch.stack(rts, 1), torch.stack(flags, 1) if failure else None,
            runner.flat_state())


# ---------------------------------------------------------------------------
# Replay mode: externally supplied candidates/times
# ---------------------------------------------------------------------------

def run_replay(policy: str, hyper: float, cand_masks, t_ud_rounds,
               t_ul_rounds, rand_rounds=None, *, s_round: int, device=None):
    """Run R rounds of one policy from precomputed inputs through the
    unfused mask pipeline (the port of ``engine_jax.run_replay``).

    ``cand_masks``: [R, K] bool; ``t_*_rounds``: [R, K]; ``rand_rounds``:
    [R, K] uniforms for the random policy.  Returns a dict with
    ``round_times`` [R], ``elapsed`` [R] (cumulative), ``selected`` [R, S]
    and the final (G = 1) state.
    """
    device = resolve_device(device)
    bandit.check_policy(policy)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    masks = t(cand_masks, torch.bool)
    t_ud, t_ul = t(t_ud_rounds), t(t_ul_rounds)
    rand = None if rand_rounds is None else t(rand_rounds)
    decay = bandit.policy_decay(policy)
    state = bandit.BanditState.create(1, masks.shape[1], device=device)
    rts, sels = [], []
    for r in range(masks.shape[0]):
        state, sel, rt = bandit.round_via_mask(
            state, masks[r][None], t_ud[r][None], t_ul[r][None],
            None if rand is None else rand[r][None], hyper, policy=policy,
            s_round=s_round, decay=decay)
        rts.append(rt[0])
        sels.append(sel[0])
    rts = torch.stack(rts)
    return {"round_times": rts, "elapsed": torch.cumsum(rts, 0),
            "selected": torch.stack(sels), "state": state}


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Round times for every (policy, eta, seed) grid point, on host."""

    policies: tuple[str, ...]
    hypers: tuple[float, ...]
    etas: tuple[float, ...]
    seeds: tuple[int, ...]
    round_times: np.ndarray     # [P, E, S, R]
    # per-slot outcome flags (core.bandit.FLAG_*) when the sweep ran with a
    # round deadline; None on fault-free sweeps
    flags: np.ndarray | None = None    # [P, E, S, R, s_round] int32
    # random values this process drew, by stream (KeyStreams.drawn)
    drawn: dict | None = None

    @property
    def elapsed(self) -> np.ndarray:
        """Final elapsed time per grid point, [P, E, S]."""
        return self.round_times.sum(axis=-1)

    def mean_elapsed(self) -> np.ndarray:
        """Seed-averaged elapsed time, [P, E] (paper Figs. 1-2 input)."""
        return self.elapsed.mean(axis=-1)

    def fault_counts(self) -> dict[str, np.ndarray]:
        """Per-grid-point outcome totals over all rounds/slots, [P, E, S]
        per category; the categories partition the dispatched slots.
        Requires a sweep run with a deadline."""
        if self.flags is None:
            raise ValueError("fault_counts() requires a sweep run with a "
                             "deadline (the failure-aware layer)")
        f = self.flags
        cat = {"ok": bandit.FLAG_OK, "crashed": bandit.FLAG_CRASH,
               "churned": bandit.FLAG_CHURN,
               "deadline_missed": bandit.FLAG_DEADLINE,
               "corrupt": bandit.FLAG_CORRUPT}
        out = {k: (f == v).sum(axis=(-2, -1)) for k, v in cat.items()}
        out["dispatched"] = (f >= 0).sum(axis=(-2, -1))
        return out


def sweep(scenario: Scenario | str = "paper-baseline",
          policies=tuple(bandit.POLICY_NAMES),
          etas=(1.0, 1.5, 1.9),
          seeds=8,
          n_rounds: int = 500,
          n_clients: int = 100,
          s_round: int = 5,
          frac_request: float = 0.1,
          model_bits: float = PAPER_MODEL_BITS,
          env_seed: int = 0,
          fluctuate: bool = True,
          *,
          deadline: float | None = None,
          devices=None,
          shard: str = "grid",
          chunk_rounds: int | None = None,
          fused: bool = True,
          fast_sampling: bool | None = None,
          hierarchy: str = "flat",
          s_cells: int | None = None,
          device=None) -> SweepResult:
    """Run the (policy x eta x seed) grid; the arguments are those of
    ``engine_jax.sweep``, plus ``device`` (None = the card; ``"cpu"`` runs
    the plain PyTorch path).

    ``policies`` entries are names or (name, hyper) pairs; ``seeds`` is an
    int (=> range) or a sequence.  ``deadline`` (seconds) switches on the
    failure-aware layer and the result's ``flags``.  Every grid point of one
    seed sees the same random draws, whatever its policy or eta.

    ``devices`` asks for P shards: None or 1 is the one-shard path, an int
    that many shards, ``"all"`` the world size.  The shards sit on the R
    ranks of the default ``torch.distributed`` process group, P/R each (R
    must divide P; with no group R = 1, one process holding every shard),
    and every rank returns the whole result (``distributed/sharding.py``).

    The random numbers are the JAX package's, drawn from the seeds'
    Threefry keys (:class:`KeyStreams`), so the result equals
    ``engine_jax.sweep``'s with the same arguments: selections and flags
    exactly, round times within float32 rounding.  ``SweepResult.drawn``
    counts the values this process drew.

    ``shard="grid"`` edge-pads the flattened (eta x seed) axis to a
    multiple of R, runs each rank's rows through the flat path (the round
    kernels on the card) and all-gathers the round times: the result equals
    the flat sweep's bitwise.  A rank draws only for the seeds of its own
    rows.

    ``shard="clients"`` splits the K clients' bandit state into P
    contiguous blocks and runs the client-sharded segmented rounds
    (``bandit.make_segmented_round_fn``) when P divides K and the round is
    streamed and fused; otherwise it runs the flat path on every rank,
    which gives the same results.  A rank holds its P/R blocks as a
    leading axis of its tensors and crosses shards by ``all_reduce`` and
    ``all_gather``.  It draws the candidate and the random policy's
    uniforms only at its own K/R clients, takes the top n_req candidates
    of its slice and all-gathers their keys (:func:`topk_lowest`), so the
    results equal the flat sweep's bitwise.  On one card this path is
    slower than the flat one at every K measured (PERF.md).

    ``chunk_rounds`` = c must divide ``n_rounds`` (ValueError otherwise, as
    in the JAX package).  The keys and the small per-round streams are
    drawn c rounds at a time (the whole run when None), the K-sized
    streams round by round; every draw depends on its round key alone, so
    the results are the unchunked ones bitwise.

    ``hierarchy="cells"`` runs the two-level selection on the streamed
    path: each round scores the scenario's ``congestion_cells`` cells by a
    naive-UCB bandit over their aggregated observed T_inc, selects
    ``s_cells`` of them (default ~sqrt(cells)) and polls
    ``ceil(n_req / s_cells)`` candidates (at most a cell's population) only
    inside those.  A scenario with at most one cell runs the flat path.  It
    does not compose with ``shard="clients"`` or ``fast_sampling=False``
    (ValueError).
    """
    if shard not in ("grid", "clients"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if hierarchy not in ("flat", "cells"):
        raise ValueError(f"unknown hierarchy mode {hierarchy!r}")
    sg = sharding.resolve_group(devices)
    check_chunk_rounds(n_rounds, chunk_rounds)
    device = resolve_device(device)
    scenario = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if s_round > n_clients:
        raise ValueError(f"s_round={s_round} exceeds n_clients={n_clients}: "
                         f"cannot select more clients than exist")
    deadline = None if deadline is None else float(deadline)
    fault = bandit.resolve_fault(scenario.fault, deadline)
    pol_names, hypers = [], []
    for p in policies:
        name, hyper = p if isinstance(p, tuple) else (p, None)
        bandit.check_policy(name)
        pol_names.append(name)
        hypers.append(float(bandit.DEFAULT_HYPERS[name]
                            if hyper is None else hyper))
    seeds = tuple(range(seeds)) if isinstance(seeds, int) else tuple(seeds)
    etas = tuple(float(e) for e in etas)
    n_req = math.ceil(n_clients * frac_request)

    cells = draw_cells = None
    if hierarchy == "cells":
        if shard == "clients":
            raise ValueError(
                "hierarchy='cells' does not compose with shard='clients': "
                "pick one scaling axis")
        if fast_sampling is False:
            raise ValueError(
                "hierarchy='cells' is built on the streamed candidate-sliced "
                "path; fast_sampling=False has no hierarchical legacy stream")
        n_cells = max(int(scenario.congestion_cells), 1)
        if n_cells > 1:         # one cell is the flat selection
            if s_cells is None:
                s_cells = round(math.sqrt(n_cells))
            s_cells = min(max(int(s_cells), 1), n_cells)
            m = -(-n_clients // n_cells)    # largest cell's population
            n_req_cell = min(max(1, -(-n_req // s_cells)), m)
            cells, draw_cells = (s_cells, n_req_cell), (s_cells, m)
            n_req = s_cells * n_req_cell
    fast = cells is not None or resolve_fast_sampling(fast_sampling,
                                                      n_clients)
    shards = (sg if sg is not None and shard == "clients" and fast and fused
              and cells is None
              and sharding.even_shards(n_clients, sg.n_shards) is not None
              else None)
    grid = sg if shard == "grid" else None

    env = scenario.build_env(n_clients, np.random.default_rng(env_seed))
    env_arrays = EnvArrays.from_scenario(scenario, env, device)
    n_grid = len(etas) * len(seeds)
    # grid point g = eta index * n_seeds + seed index; this process's rows
    rows = (torch.arange(n_grid) if grid is None
            else sharding.grid_rows(n_grid, grid))
    g_eta = torch.tensor(etas, dtype=torch.float32).repeat_interleave(
        len(seeds))[rows].to(device)
    mine, seed_rows = torch.unique(rows % len(seeds), return_inverse=True)
    if torch.equal(seed_rows, torch.arange(len(mine))):
        seed_rows = None                         # one row per seed
    clients = (None if shards is None or shards.group is None else
               (shards.first * (n_clients // shards.n_shards),
                shards.per_rank * (n_clients // shards.n_shards)))
    streams = KeyStreams(
        [seeds[i] for i in mine.tolist()], n_rounds, device,
        rows=None if seed_rows is None else seed_rows.to(device),
        chunk=chunk_rounds, clients=clients,
        group=None if clients is None else shards.group)

    rts_all, flags_all = [], []
    for name, hyper in zip(pol_names, hypers):
        draws = (draw_round_inputs(
            streams, rnd=r, k=n_clients, n_req=n_req, s_round=s_round,
            fast=fast, fluctuate=fluctuate, policy=name, scen=scenario,
            fault=fault, cells=draw_cells) for r in range(n_rounds))
        rts, flags, _ = run_rounds(
            env_arrays, g_eta, draws, policy=name, scen=scenario,
            s_round=s_round, hyper=hyper, model_bits=float(model_bits),
            fluctuate=fluctuate, fast=fast, fused=fused, deadline=deadline,
            shards=shards, cells=cells)
        rts_all.append(rts)
        flags_all.append(flags)
    rts = torch.stack(rts_all, 1)                       # [G', P, R]
    flags = None if deadline is None else torch.stack(flags_all, 1)
    if grid is not None:
        rts = sharding.gather_shards(rts, 0, grid.group)[:n_grid]
        flags = (None if flags is None
                 else sharding.gather_shards(flags, 0, grid.group)[:n_grid])
    shape = (len(etas), len(seeds), len(pol_names), n_rounds)
    rts = rts.cpu().numpy().reshape(shape).transpose(2, 0, 1, 3)
    if flags is not None:
        flags = flags.cpu().numpy().reshape(shape + (s_round,)).transpose(
            2, 0, 1, 3, 4)
    return SweepResult(policies=tuple(pol_names), hypers=tuple(hypers),
                       etas=etas, seeds=seeds,
                       round_times=np.ascontiguousarray(rts),
                       flags=None if flags is None
                       else np.ascontiguousarray(flags),
                       drawn=dict(streams.drawn))
