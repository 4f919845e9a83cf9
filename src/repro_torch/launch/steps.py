"""Step functions — the port of ``repro.launch.steps`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``).

``make_train_step(api, opt_cfg, mp=None)`` gives ``train_step(params,
opt_state, batch) -> (params, opt_state, loss)``: the model's ``loss_fn``,
its gradient by autograd (through the attention and scan kernels'
``torch.autograd.Function``\\ s on the card, kernels/ops.py), then the
optimizer's functional update.  The parameters passed in are not changed;
new ones are returned, as in the JAX package.  With ``cfg.remat`` the
model recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` does; on a mesh
that runs the recomputed layers' collectives a second time.

On a device mesh (``mp`` a ``models/layers.ModelParallel``) the step takes
this rank's blocks of the parameters (``sharding.shard_params`` by
``param_specs``), of the AdamW state (by ``opt_specs``: the moments take
the parameters' specs) and of the batch (``batch_specs``), and returns its
updated blocks.  The gradient flows back through the collectives'
autograd Functions (distributed/sharding.py), which leave every leaf's
gradient on this rank covering its own batch rows; each leaf is then
summed once over the batch axes its spec does not split
(:func:`sum_over_batch`; a leaf split over ``data`` by FSDP was summed by
its gather's reduce-scatter).  AdamW is elementwise, with no global norm,
so each block's update is the one-process update of that block.

``build_cell(arch, shape, mesh)`` assembles one dry-run cell (an
architecture at one of ``configs/shapes.SHAPES`` on a mesh): the step
function, its arguments on the ``meta`` device, and the spec trees of the
parameters, the optimizer state, the batch and the cache
(distributed/sharding.py), with the JAX package's FSDP rule (on above
3·10⁹ parameters) and AdamW default.  launch/dryrun.py runs one rank of
it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding
from repro_torch.models.registry import ModelApi, build
from repro_torch.optim.sgd import OptimizerConfig
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn: Callable, params: dict, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)`` with respect to every
    floating leaf of ``params`` (a leaf the loss does not use gets zeros,
    as ``jax.grad`` gives); ``loss`` is detached."""
    p = tree_map(lambda x: x.detach().requires_grad_(x.is_floating_point()),
                 params)
    leaves = tree_leaves(p)
    with torch.enable_grad():
        loss = loss_fn(p, *args)
        grads = iter(torch.autograd.grad(
            loss, [x for x in leaves if x.requires_grad], allow_unused=True))
    out = [next(grads) if x.requires_grad else None for x in leaves]
    out = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, out)]
    return loss.detach(), tree_unflatten(params, out)


def sum_over_batch(grads, mp) -> Any:
    """Each leaf of ``grads`` (this rank's, of its own batch rows) summed
    in place over the batch axes its spec (``mp.specs``) does not split,
    when the batch is split over them: the whole batch's gradient of that
    block.  Returns ``grads``."""
    if mp.batch_group is None:
        return grads
    axes = sharding.batch_axes(mp.sizes)

    def total(path, g):
        spec = sharding.spec_at(mp.specs, path)
        split = {a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry)}
        left = tuple(a for a in axes if a not in split)
        if left:             # FSDP splits data alone: at most pod is left
            sharding.all_reduce(g, mp.batch_group if left == axes
                                else mp.group(left[0]))
        return g
    return sharding.map_with_path(total, grads)


def make_train_step(api: ModelApi, opt_cfg: OptimizerConfig, mp=None):
    """``(train_step, optimizer)``; ``optimizer.init(params)`` makes the
    state the step takes.  With ``mp`` (module docstring) every argument
    and result is this rank's block.  ``train_step`` also takes ``mp=`` in
    a call, as the prefill and decode steps do (the dry run builds its
    rank's view only when it runs the cell)."""
    opt = opt_cfg.build()
    default = mp

    def train_step(params, opt_state, batch, mp=default):
        loss_fn = api.loss_fn if mp is None else functools.partial(
            api.loss_fn, mp=mp)
        loss, grads = value_and_grad(loss_fn, params, batch)
        if mp is not None:
            grads = sum_over_batch(grads, mp)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return train_step, opt


def make_prefill_step(api: ModelApi, max_len: int):
    def prefill_step(params, batch, mp=None):
        return api.prefill(params, batch, max_len=max_len, mp=mp)
    return prefill_step


def make_decode_step(api: ModelApi):
    def decode_step(params, cache, tokens, pos, mp=None):
        return api.decode_step(params, cache, tokens, pos, mp=mp)
    return decode_step


@dataclasses.dataclass
class LoweredSpec:
    """One (arch x shape x mesh) cell: ``fn(*abstract_args)`` is its step
    (``mp=`` a ``layers.ModelParallel`` for one rank), the arguments whole
    on the ``meta`` device; the spec trees mirror the parameters, the
    optimizer state (train cells), the batch and the cache (decode
    cells)."""
    fn: Callable
    abstract_args: tuple
    param_specs: Any
    opt_specs: Any
    batch_specs: Any
    cache_specs: Any
    static: dict


def build_cell(arch: str, shape: str, mesh, fsdp: bool | None = None,
               opt_cfg: OptimizerConfig | None = None,
               reduced: bool = False) -> LoweredSpec:
    """Assemble fn + abstract args + specs for one dry-run cell; ``mesh``
    a ``DeviceMesh`` or its axis sizes {name: size}."""
    api = build(arch, reduced=reduced)
    cell = SHAPES[shape]
    cfg = api.cfg
    if fsdp is None:
        # FSDP on for the big archs (params do not fit replicated-over-data)
        total, _ = api.param_counts()
        fsdp = total > 3e9
    if opt_cfg is None:
        opt_cfg = OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1)

    pshapes = api.param_shapes()
    pspecs = sharding.param_specs(pshapes, cfg, mesh, fsdp=fsdp)
    in_specs = api.input_specs(shape)
    bspecs = sharding.batch_specs(in_specs, mesh)

    if cell.kind == "train":
        fn, opt = make_train_step(api, opt_cfg)
        oshapes = opt.init(pshapes)
        return LoweredSpec(
            fn=fn, abstract_args=(pshapes, oshapes, in_specs),
            param_specs=pspecs, opt_specs=sharding.opt_specs(oshapes, pspecs),
            batch_specs=bspecs, cache_specs=None,
            static={"fsdp": fsdp, "opt": opt_cfg.name})

    if cell.kind == "prefill":
        return LoweredSpec(
            fn=make_prefill_step(api, max_len=cell.seq_len),
            abstract_args=(pshapes, in_specs), param_specs=pspecs,
            opt_specs=None, batch_specs=bspecs, cache_specs=None,
            static={"fsdp": fsdp})

    cshapes = api.decode_state_specs(shape)
    return LoweredSpec(
        fn=make_decode_step(api),
        abstract_args=(pshapes, cshapes, in_specs["tokens"],
                       cell.seq_len - 1),
        param_specs=pspecs, opt_specs=None, batch_specs=bspecs,
        cache_specs=sharding.cache_specs(cshapes, cfg, mesh),
        static={"fsdp": fsdp})
