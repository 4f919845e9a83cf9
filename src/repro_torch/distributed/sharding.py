"""Sharding over ``torch.distributed`` ranks — the port of the sweep half
of ``repro.distributed.sharding`` (``sweep_mesh``, ``pad_leading``,
``shard_vmapped``, ``shard_leading``, ``even_shards``,
``bandit_state_bytes``) plus the two cross-shard steps of the segmented
round.

A JAX device is a rank here, one card each.  A sweep's ``devices`` = P
asks for P shards; :func:`resolve_group` spreads them over the R ranks of
the default process group as P/R contiguous blocks per rank (R must divide
P).  With no process group R = 1 and the one process holds every block;
then no collective runs.  Two layouts, as in the JAX package:

  * the grid layout (``shard="grid"``): the flattened (eta x seed) axis is
    edge-padded to a multiple of R (:func:`pad_leading`), each rank runs
    its rows (:func:`grid_rows`) and the results are all-gathered
    (:func:`gather_shards` along the rows), so every rank returns the
    whole grid;
  * the client layout (``shard="clients"``): shard p owns global clients
    [p*K/P, (p+1)*K/P).  On a rank the blocks are a leading [P/R] axis of
    tensors (:func:`shard_leading`, a view); ``psum`` is the local sum over
    that axis then ``all_reduce`` (:func:`sum_shards`) and ``all_gather``
    is an all-gather along it (:func:`gather_shards`).

A sharded :class:`~repro_torch.core.bandit.BanditState` holds one row per
(grid point, block of this rank): leaves of [G*P/R, K/P] (a reshape of
[G, P/R, K/P]), with the scalar counters ``total`` and ``disc_total``
replicated over the block rows, as each JAX shard keeps its own copy.

A collective runs on the tensors as they are: NCCL takes CUDA tensors and
gloo CPU ones, and a mismatch raises (no copy through the host).  JAX's
``replicate`` has no counterpart: every rank holds its own copy of what is
not sharded.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.bandit import BanditState


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """P shards over the R ranks of a process group (``group`` None: one
    process holding every block, no collectives)."""

    n_shards: int                 # P
    world: int = 1                # R
    rank: int = 0
    group: object | None = None

    @property
    def per_rank(self) -> int:
        """Blocks on each rank, P/R."""
        return self.n_shards // self.world

    @property
    def first(self) -> int:
        """Global index of this rank's first block."""
        return self.rank * self.per_rank


def place(n_shards: int, group=None) -> ShardGroup:
    """P shards over the ranks of the process group ``group`` (None: one
    process holding every block, no collectives); R must divide P."""
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{world} ranks")
    return ShardGroup(n_shards, world, rank, group)


def resolve_group(devices) -> ShardGroup | None:
    """A sweep's ``devices`` argument -> its :class:`ShardGroup` over the
    default process group when one is initialised, or None for the
    one-shard path (the counterpart of ``engine_jax``'s
    ``resolve_sweep_mesh``).  ``devices``: None, 0 or 1 (one shard), a
    number of shards, or ``"all"`` (the world size)."""
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    if devices == "all":
        n = 1 if group is None else dist.get_world_size(group)
    elif devices is None or (isinstance(devices, int)
                             and not isinstance(devices, bool)
                             and devices >= 0):
        n = devices or 1
    else:
        raise ValueError(f"devices must be None, a number of shards or "
                         f"'all', got {devices!r}")
    return None if n == 1 else place(n, group)


def as_group(shards) -> ShardGroup:
    """A :class:`ShardGroup`, or an int P (one process, every block)."""
    return shards if isinstance(shards, ShardGroup) else ShardGroup(
        int(shards))


def even_shards(k: int, n_shards: int | None) -> int | None:
    """K/P when ``n_shards`` splits the K clients evenly (the block size of
    :func:`shard_leading`), else None.  None or 1 shard means no sharding
    (None), as one device does in the JAX package."""
    if n_shards in (None, 0, 1):
        return None
    return k // n_shards if k % n_shards == 0 else None


def shard_leading(x: torch.Tensor, n_shards: int, dim: int = 0):
    """The ``n_shards`` contiguous client blocks of ``x`` along its client
    axis ``dim``: [..., K, ...] -> [..., P, K/P, ...], a view."""
    return x.unflatten(dim, (n_shards, -1))


def pad_leading(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Edge-pad the leading axis up to a multiple of ``multiple`` (the last
    row repeated); the caller cuts the padded tail off the result."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def grid_rows(n_rows: int, sg: ShardGroup, device=None) -> torch.Tensor:
    """This rank's rows of a grid of ``n_rows`` points padded to a multiple
    of R (a rank runs its P/R blocks in one call, so padding to P would
    only add rows): indices into [0, n_rows), the padded tail repeating
    the last."""
    rows = pad_leading(torch.arange(n_rows, device=device), sg.world)
    per = rows.shape[0] // sg.world
    return rows[sg.rank * per:(sg.rank + 1) * per]


def _check_backend(x: torch.Tensor, group) -> None:
    backend = dist.get_backend(group)
    if (backend == "nccl") != x.is_cuda:
        raise ValueError(f"a {backend} collective got a tensor on "
                         f"{x.device}: NCCL takes CUDA tensors and gloo CPU "
                         f"ones")


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` in place (no-op for None)."""
    if group is not None:
        _check_backend(x, group)
        dist.all_reduce(x, op=op, group=group)
    return x


def sum_shards(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The cross-shard sum over the block axis ``dim`` (``psum``), in
    ``x``'s dtype: this rank's blocks summed, then over the ranks."""
    return all_reduce(x.sum(dim, dtype=x.dtype), group)


def gather_shards(x: torch.Tensor, dim: int = 1, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``all_gather``): the block axis [..., P/R, ...] -> [..., P, ...], or a
    grid's rows.  On one process (``group`` None) ``x`` already holds them
    all.  Every rank's ``x`` has the same shape."""
    if group is None:
        return x
    x = x.contiguous()
    _check_backend(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def shard_state(state: BanditState, n_shards: int) -> BanditState:
    """[G, K'] state -> the sharded [G*P', K'/P'] state of its P' blocks
    (views of the same memory; the counters repeated over the block
    rows)."""
    g = state.n_sel.shape[0]
    leaves = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        leaves[f.name] = (x.repeat_interleave(n_shards) if x.dim() == 1
                          else x.reshape(g * n_shards, -1, *x.shape[2:]))
    return BanditState(**leaves)


def unshard_state(state: BanditState, n_shards: int) -> BanditState:
    """The inverse of :func:`shard_state`: [G*P', K'/P'] -> [G, K'], the
    counters from block 0 (all blocks hold the same)."""
    gp = state.n_sel.shape[0]
    g = gp // n_shards
    leaves = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        leaves[f.name] = (x.view(g, n_shards)[:, 0].contiguous()
                          if x.dim() == 1
                          else x.reshape(g, -1, *x.shape[2:]))
    return BanditState(**leaves)


def bandit_state_bytes(k: int, n_shards: int = 1) -> int:
    """Bytes of bandit state one shard holds for one grid point at K
    clients over ``n_shards`` blocks: the per-client leaves split K/P per
    shard, the scalar counters replicate.  Computed from the fields of
    :class:`~repro_torch.core.bandit.BanditState` (on the meta device, no
    allocation)."""
    state = BanditState.create(1, k, device="meta")
    total = 0
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        nbytes = x.numel() * x.element_size()
        total += nbytes if x.dim() == 1 else -(-nbytes // n_shards)
    return total
