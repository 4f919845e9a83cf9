"""Client-axis sharding of the bandit state — the port of what the
segmented sweep needs from ``repro.distributed.sharding`` (``even_shards``,
``shard_leading``, ``bandit_state_bytes``) plus the two cross-shard steps.

The JAX package splits the K clients over P devices as contiguous blocks
(shard p owns global clients [p*K/P, (p+1)*K/P)) and runs the round inside
``shard_map``, crossing shards with ``psum`` and ``all_gather``.  Here the
P blocks are a leading [P] axis of tensors on one card: the block layout is
a view of the flat one (``shard_leading``), ``psum`` is a sum over the
shard axis (:func:`sum_shards`) and ``all_gather`` is the [P, ...] tensor
itself (:func:`gather_shards`).  A layout over several cards replaces only
those two functions.

A sharded :class:`~repro_torch.core.bandit.BanditState` holds one row per
(grid point, shard): leaves of [G*P, K/P] (row g*P + p is block p of grid
point g; a reshape of [G, P, K/P]), with the scalar counters ``total`` and
``disc_total`` replicated over the shard rows, as each JAX shard keeps its
own replicated copy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bandit import BanditState


def even_shards(k: int, n_shards: int | None) -> int | None:
    """K/P when ``n_shards`` splits the K clients evenly (the block size of
    :func:`shard_leading`), else None.  None or 1 shard means no sharding
    (None), as one device does in the JAX package."""
    if n_shards in (None, 0, 1):
        return None
    return k // n_shards if k % n_shards == 0 else None


def shard_leading(x: torch.Tensor, n_shards: int, dim: int = 0):
    """The P contiguous client blocks of ``x`` along its client axis
    ``dim``: [..., K, ...] -> [..., P, K/P, ...], a view."""
    return x.unflatten(dim, (n_shards, -1))


def sum_shards(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The cross-shard sum over the shard axis ``dim`` (``psum``), in
    ``x``'s dtype."""
    return x.sum(dim, dtype=x.dtype)


def gather_shards(x: torch.Tensor) -> torch.Tensor:
    """Every shard's rows, [..., P, ...] (``all_gather``): on one card the
    shard axis already holds them all."""
    return x


def shard_state(state: BanditState, n_shards: int) -> BanditState:
    """[G, K] state -> the sharded [G*P, K/P] state (views of the same
    memory; the counters repeated over the shard rows)."""
    g = state.n_sel.shape[0]
    leaves = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        leaves[f.name] = (x.repeat_interleave(n_shards) if x.dim() == 1
                          else x.reshape(g * n_shards, -1, *x.shape[2:]))
    return BanditState(**leaves)


def unshard_state(state: BanditState, n_shards: int) -> BanditState:
    """The inverse of :func:`shard_state`: [G*P, K/P] -> [G, K], the
    counters from shard 0 (all shards hold the same)."""
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
