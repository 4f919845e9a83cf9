"""The paper's FL protocol as a distributed training step — the port of
``repro.distributed.fl_parallel`` over ``torch.distributed`` ranks.

Arms = cohorts: each cohort holds one FL client's model replica and data.
The C cohorts sit on the R ranks of a process group as a leading [C/R]
axis of each rank's tensors (rank r holds cohorts [r*C/R, (r+1)*C/R)); with
no group one process holds them all.  One FL round =

  1. local steps — every cohort runs E local steps of the port's optimizer
     (``optim/sgd.py``) with no cross-cohort communication: a loop over
     the rank's cohorts, since the attention and scan kernels' autograd
     Functions do not run under ``torch.func.vmap``;
  2. aggregation — masked weighted FedAvg across cohorts
     (:func:`fedavg_across_cohorts`).  The weights come from the bandit
     selector: an unselected cohort gets weight 0.  The upload can be
     compressed on the wire: int8 or top-k deltas all-gathered instead of
     float32 parameters.

Two layouts, as :func:`make_fl_round` is called:

  * no mesh: the C cohorts over the ranks of ``group`` (None: one process
    holds them all), each cohort's model whole on its rank;
  * a (data, model) device mesh and the stacked specs
    (:func:`stacked_param_specs`), as in the JAX package: cohorts over
    ``sharding.cohort_axes(mesh)``, and tensor parallelism over ``model``
    inside each cohort.  A rank holds its cohorts' blocks of every leaf
    (``param_specs`` with FSDP off, the specs less their cohort entry), and
    a cohort's local steps run the model's model-parallel routes through
    ``mp`` (``models/layers.ModelParallel``, the cohort's batch whole on
    each of its ranks), their gradients through the collectives' autograd
    Functions (distributed/sharding.py).  Aggregation works on each rank's
    own block, over the ranks that hold the same block of the other
    cohorts (:func:`cohort_group`), as JAX's ``shard_map`` over the local
    block does: the int8 scales, the int8_psum max and the top-k choice
    are per (cohort, block), so the compressed modes' numbers are JAX's on
    the same mesh.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.bandit import fdiv
from repro_torch.distributed import compression, sharding
from repro_torch.distributed.sharding import all_reduce, gather_shards
from repro_torch.kernels import ops
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.layers import ModelParallel
from repro_torch.optim.sgd import Optimizer
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

COMPRESS = ("none", "int8", "int8_psum", "topk")


# ---------------------------------------------------------------------------
# local phase: E steps per cohort, no cross-cohort communication
# ---------------------------------------------------------------------------

def make_local_steps(loss_fn: Callable, opt: Optimizer, n_steps: int):
    """Returns f(params, opt_state, batches) -> (params, opt_state, loss)
    for ONE client: ``n_steps`` steps of ``opt`` on the gradient of
    ``loss_fn(params, batch) -> scalar``.  ``batches`` is a tree whose
    leaves are [n_steps, ...] stacked minibatches; the returned loss is the
    mean over the local steps."""

    def local(params, opt_state, batches):
        losses = []
        for i in range(n_steps):
            loss, grads = value_and_grad(loss_fn, params,
                                         tree_map(lambda x: x[i], batches))
            params, opt_state = opt.update(grads, opt_state, params)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    return local


def stack_for_cohorts(tree: Any, n_cohorts: int) -> Any:
    """Replicate a single model into the [C, ...] stacked layout (views)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n_cohorts, *x.shape),
                    tree)


def _stack(trees: list) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _cohort(tree: Any, i: int) -> Any:
    return tree_map(lambda x: x[i], tree)


def init_cohort_states(opt: Optimizer, stacked: Any) -> Any:
    """The optimizer state of every cohort of ``stacked``, stacked (the JAX
    package's ``jax.vmap(opt.init)``)."""
    n = tree_leaves(stacked)[0].shape[0]
    return _stack([opt.init(_cohort(stacked, i)) for i in range(n)])


# ---------------------------------------------------------------------------
# aggregation phase: masked weighted FedAvg across the cohort axis
# ---------------------------------------------------------------------------

def _ranks(group) -> tuple[int, int]:
    return ((1, 0) if group is None
            else (dist.get_world_size(group), dist.get_rank(group)))


def _segments(like: Any) -> list[tuple[int, int]]:
    """(offset, size) of each leaf of ``like`` in the flat row layout."""
    out, off = [], 0
    for x in tree_leaves(like):
        out.append((off, x.numel()))
        off += x.numel()
    return out


def _unflat(vec: torch.Tensor, like: Any) -> Any:
    """[N] float32 -> a tree of ``like``'s leaf shapes."""
    return tree_unflatten(like, [
        vec[o:o + n].view(x.shape)
        for (o, n), x in zip(_segments(like), tree_leaves(like))])


def fedavg_across_cohorts(stacked_params: Any, weights: torch.Tensor,
                          compress: str = "none", topk_ratio: float = 0.01,
                          base_params: Any | None = None,
                          group=None) -> Any:
    """Weighted FedAvg of this rank's cohorts and every other rank's.

    ``stacked_params``: a tree whose leaves carry this rank's C/R cohorts
    as their leading dim; ``weights``: [C] float32 over all cohorts
    (selection mask x data size), normalised here by ``max(sum, 1e-9)``;
    ``base_params``: the pre-round global model (the compressed modes send
    deltas against it); ``group``: the process group (None: one process,
    every cohort).  Returns the aggregated tree without the cohort dim, the
    same on every rank.  Wire formats (bytes a rank sends, N parameters, C
    cohorts, as the JAX package's docstring counts them):

      none      — each rank's weighted partial sum of its cohorts' rows
                  through ``ops.fedavg_combine`` (the CUDA kernel on the
                  card, the same function as the JAX package's f32 einsum),
                  then an f32 ``all_reduce``                       ~ 2N*4
      int8      — ``all_gather`` of the int8 deltas and the f32 scales (one
                  a cohort and leaf), combined by ``ops.fedavg_combine`` ~ C*N
      int8_psum — a shared scale per leaf (``all_reduce(MAX)`` of |w*d|),
                  w*d quantized to int8 and summed over the ranks.  NCCL
                  has no int16 reduction, so the integers travel as int32:
                  the same sums (C <= 256 cannot overflow int16 either), but
                  twice the JAX package's int16 wire bytes          ~ 2N*4
      topk      — ``all_gather`` of the top-k values and int32 indices of
                  each cohort's leaves, scattered and combined by
                  ``ops.fedavg_combine``                        ~ 8*C*N*ratio
    """
    if compress not in COMPRESS:
        raise ValueError(f"unknown compress mode {compress!r}")
    world, rank = _ranks(group)
    n_all = weights.shape[0]
    c = tree_leaves(stacked_params)[0].shape[0]
    if c * world != n_all:
        raise ValueError(f"{c} cohorts on each of {world} ranks, but "
                         f"{n_all} weights")
    w = weights / weights.sum().clamp_min(1e-9)
    w_loc = w[rank * c:(rank + 1) * c].contiguous()

    if compress == "none":
        rows = torch.cat([x.reshape(c, -1).float()
                          for x in tree_leaves(stacked_params)], 1)
        avg = all_reduce(ops.fedavg_combine(rows, w_loc), group)
        return tree_map(lambda a, x: a.to(x.dtype),
                        _unflat(avg, _cohort(stacked_params, 0)),
                        _cohort(stacked_params, 0))

    if base_params is None:
        raise ValueError("compressed aggregation needs the base model")
    deltas = [sp.float() - bp.float()[None] for sp, bp in
              zip(tree_leaves(stacked_params), tree_leaves(base_params))]

    def gather(per_leaf, join=torch.cat):
        """[C, ...] over all ranks from per_leaf[leaf][cohort] pieces."""
        return gather_shards(torch.stack([join([x[i] for x in per_leaf])
                                          for i in range(c)]), 0, group)
    if compress == "int8":
        codes = [[compression.quantize_int8(d[i]) for i in range(c)]
                 for d in deltas]
        q = gather([[x[0].reshape(-1) for x in cl] for cl in codes])
        scale = gather([[x[1] for x in cl] for cl in codes],
                       torch.stack)                            # [C, L]
        parts = torch.cat([q[:, o:o + n].float() * scale[:, l:l + 1]
                           for l, (o, n) in enumerate(
                               _segments(base_params))], 1)
        avg = ops.fedavg_combine(parts, w)
    elif compress == "int8_psum":
        wd = [w_loc.view(c, *([1] * (d.dim() - 1))) * d for d in deltas]
        gmax = all_reduce(torch.stack([x.abs().max() for x in wd]), group,
                          op=dist.ReduceOp.MAX) + 1e-12
        scale = fdiv(gmax, 127.0)                                 # [L]
        total = all_reduce(torch.cat([
            torch.clamp(torch.round(x / scale[l]), -127, 127).to(
                torch.int32).sum(0).reshape(-1)
            for l, x in enumerate(wd)]), group)                   # [N] int32
        avg = torch.cat([total[o:o + n].float() * scale[l] for l, (o, n)
                         in enumerate(_segments(base_params))])
    else:                                                         # topk
        sparse = [[compression.topk_compress(d[i], topk_ratio)
                   for i in range(c)] for d in deltas]
        vals = gather([[x[0] for x in sl] for sl in sparse])
        idx = gather([[x[1] for x in sl] for sl in sparse])
        parts, at = [], 0
        for sl, (_, n) in zip(sparse, _segments(base_params)):
            k = sl[0][2]
            parts.append(vals.new_zeros(n_all, n).scatter_(
                1, idx[:, at:at + k].long(), vals[:, at:at + k]))
            at += k
        avg = ops.fedavg_combine(torch.cat(parts, 1), w)
    return tree_map(lambda bp, a: (bp.float() + a).to(bp.dtype), base_params,
                    _unflat(avg, base_params))


# ---------------------------------------------------------------------------
# the full FL round
# ---------------------------------------------------------------------------

def stacked_param_specs(pspecs: Any, mesh) -> Any:
    """Every leaf's spec with the cohort axes prepended (the leading
    cohort dim of the stacked layout), as the JAX package's
    ``P(cohort_axes, *spec)``; ``mesh`` a ``DeviceMesh`` or its axis
    sizes."""
    ca = sharding.cohort_axes(mesh)
    return sharding.map_with_path(
        lambda _, s: sharding.Spec((ca,) + tuple(s)), pspecs)


def cohort_group(mesh):
    """The process group of the ranks of ``mesh`` that share this rank's
    coordinates on every axis but the cohort axes: they hold the same
    block of the other cohorts' models."""
    ca = sharding.cohort_axes(mesh)
    if len(ca) == 1:
        return mesh.get_group(ca[0])
    return mesh[ca]._flatten().get_group()


def make_fl_round(loss_fn: Callable, opt: Optimizer, n_local_steps: int,
                  mesh=None, stacked_specs: Any = None,
                  compress: str = "none", topk_ratio: float = 0.01,
                  group=None):
    """Builds fl_round(global_params, stacked_opt, batches, weights)
    -> (new_global_params, new_stacked_opt, mean_loss).

    ``global_params``: the single model, the same on every rank of a
    cohort group; ``stacked_opt``/``batches``: this rank's cohorts'
    optimizer states (:func:`init_cohort_states`) and [C/R, n_local_steps,
    ...] minibatches; ``weights`` [C] = selection mask x n_samples over
    all cohorts (zeros drop a cohort).  The mean loss is the
    weight-averaged local loss over all cohorts.

    With no ``mesh`` each cohort's model lies whole on its rank and the
    cohorts sit on the ranks of ``group``; ``loss_fn(params, batch)``.
    With a ``DeviceMesh`` and ``stacked_specs`` (:func:`stacked_param_specs`
    of the model's ``param_specs``), the JAX package's contract: the
    cohorts sit on the cohort axes, ``global_params`` and ``stacked_opt``
    are this rank's blocks, and ``loss_fn(params, batch, mp=...)`` runs the
    model-parallel routes over ``model`` (module docstring); the result is
    this rank's block of the new global model.
    """
    if compress not in COMPRESS:
        raise ValueError(f"unknown compress mode {compress!r}")
    if (mesh is None) != (stacked_specs is None):
        raise ValueError("a mesh takes its stacked specs, and only then")
    if mesh is not None:
        if group is not None:
            raise ValueError("on a mesh the cohort group is the mesh's")
        group = cohort_group(mesh)
        pspecs = sharding.map_with_path(
            lambda _, s: sharding.Spec(tuple(s)[1:]), stacked_specs)

    def fl_round(global_params, stacked_opt, batches, weights):
        c = tree_leaves(batches)[0].shape[0]
        step_loss = loss_fn
        if mesh is not None:
            mp = ModelParallel.of(mesh, pspecs,
                                  tree_leaves(batches)[0].shape[2],
                                  split_batch=False)
            step_loss = functools.partial(loss_fn, mp=mp)
        local = make_local_steps(step_loss, opt, n_local_steps)
        stacked = stack_for_cohorts(global_params, c)
        outs = [local(_cohort(stacked, i), _cohort(stacked_opt, i),
                      _cohort(batches, i)) for i in range(c)]
        new_p = _stack([o[0] for o in outs])
        new_o = _stack([o[1] for o in outs])
        agg = fedavg_across_cohorts(
            new_p, weights, compress=compress, topk_ratio=topk_ratio,
            base_params=global_params if compress != "none" else None,
            group=group)
        world, rank = _ranks(group)
        w = weights / weights.sum().clamp_min(1e-9)
        losses = torch.stack([o[2] for o in outs])
        mean_loss = all_reduce((losses * w[rank * c:(rank + 1) * c]).sum(),
                               group)
        return agg, new_o, mean_loss

    return fl_round
