"""Step functions — the port of ``repro.launch.steps`` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``).

``make_train_step(api, opt_cfg)`` gives ``train_step(params, opt_state,
batch) -> (params, opt_state, loss)``: the model's ``loss_fn``, its
gradient by autograd (through the attention and scan kernels'
``torch.autograd.Function``\\ s on the card, kernels/ops.py), then the
optimizer's functional update.  The parameters passed in are not changed;
new ones are returned, as in the JAX package.  With ``cfg.remat`` the
model recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` does.

The JAX module's ``build_cell`` (abstract arguments and mesh shardings for
the dry run) has no counterpart yet: the port runs on one card.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import ModelApi
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


def make_train_step(api: ModelApi, opt_cfg: OptimizerConfig):
    """``(train_step, optimizer)``; ``optimizer.init(params)`` makes the
    state the step takes."""
    opt = opt_cfg.build()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(api.loss_fn, params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return train_step, opt


def make_prefill_step(api: ModelApi, max_len: int):
    def prefill_step(params, batch):
        return api.prefill(params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(api: ModelApi):
    def decode_step(params, cache, tokens, pos):
        return api.decode_step(params, cache, tokens, pos)
    return decode_step
