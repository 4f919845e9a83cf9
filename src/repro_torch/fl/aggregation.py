"""Aggregation step: weighted FedAvg (McMahan et al., paper ref [2]) — the
port of ``repro.fl.aggregation`` (``GUARD_MAX_NORM``, ``update_ok``,
``fedavg``, ``fedavg_delta``).

global' = sum_k (D_k / sum D) * params_k over the surviving clients.  With
``use_kernel`` the combine runs over the flattened parameter vectors through
``kernels/ops.fedavg_combine`` (the CUDA kernel for tensors on the card);
otherwise it is the left-to-right ``tree_weighted_sum``.  Both compute the
same sum in the same order.  Parameters are a dict of tensors, flat (the
CNN) or nested (the LMs).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.trees import (tree_leaves, tree_map, tree_sub,
                                     tree_unflatten, tree_weighted_sum)

# Reject any client update whose flattened L2 norm exceeds this (a diverged
# or corrupted local run), besides any update holding a non-finite value.
GUARD_MAX_NORM = 1e8


def update_ok(params: dict, max_norm: float = GUARD_MAX_NORM) -> bool:
    """True iff a client update is safe to aggregate: every leaf finite and
    the flattened L2 norm at most ``max_norm``.  The host-side twin of the
    row guard in fl/engine.py."""
    flat = _flat(params)
    return (bool(torch.isfinite(flat).all())
            and bool(torch.sqrt(torch.sum(torch.square(flat))) <= max_norm))


def _flat(params: dict) -> torch.Tensor:
    """One float32 vector of a parameter dict's leaves, in key order."""
    return torch.cat([p.reshape(-1).float() for p in tree_leaves(params)])


def fedavg(client_params: list[dict], weights, use_kernel: bool | None = None,
           guard: bool = False) -> dict:
    """Weighted average of client parameter dicts.

    ``use_kernel`` routes the combine through ``kernels/ops.fedavg_combine``
    over the stacked flat vectors; None means the kernel when the parameters
    lie on the card.  ``guard`` drops clients whose update fails
    :func:`update_ok` before averaging, the surviving weights renormalised;
    it raises ValueError when every update is rejected (the caller decides
    what an empty round means).
    """
    if guard:
        kept = [(p, w) for p, w in zip(client_params, weights)
                if update_ok(p)]
        if not kept:
            raise ValueError(
                f"fedavg guard rejected all {len(client_params)} client "
                f"updates (non-finite or norm-exploding); keeping the "
                f"previous global model is the caller's choice")
        client_params = [p for p, _ in kept]
        weights = [w for _, w in kept]
    # float32 normalisation, as the engine's combine does it
    w = np.asarray(weights, dtype=np.float32)
    w = w / w.sum()
    like = tree_leaves(client_params[0])
    if use_kernel is None:
        use_kernel = like[0].is_cuda
    if not use_kernel:
        return tree_weighted_sum(client_params, [float(v) for v in w])
    from repro_torch.kernels.ops import fedavg_combine
    stacked = torch.stack([_flat(p) for p in client_params])
    avg = fedavg_combine(stacked, torch.as_tensor(w, device=like[0].device))
    leaves, off = [], 0
    for x in like:
        leaves.append(avg[off:off + x.numel()].view(x.shape).to(
            x.dtype, copy=True))
        off += x.numel()
    return tree_unflatten(client_params[0], leaves)


def fedavg_delta(global_params: dict, client_params: list[dict], weights,
                 server_lr: float = 1.0) -> dict:
    """Server-side update form: global + lr * sum w_k (client_k - global).
    Equal to :func:`fedavg` at lr = 1; a smaller lr damps noisy cohorts."""
    w = np.asarray(weights, dtype=np.float64)
    w = (w / w.sum()).astype(np.float32)
    deltas = [tree_sub(cp, global_params) for cp in client_params]
    avg = tree_weighted_sum(deltas, [float(v) for v in w])
    return tree_map(lambda g, d: g + server_lr * d, global_params, avg)
