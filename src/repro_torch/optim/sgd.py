"""Optimizers and the paper's SGD schedule — the port of ``repro.optim.sgd``
(``Optimizer``, ``PAPER_LR0``, ``PAPER_LR_DECAY``, ``paper_lr``, ``sgd``,
``adamw``, ``exponential_decay``, ``cosine_schedule``, ``OptimizerConfig``)
and of the engine's ``_round_lrs``.

Sect. IV-B: SGD, initial lr 0.25, multiplicative decay 0.99 per round,
minibatch 50, 5 local epochs (the last two live in fl/engine.py, whose
client update writes ``p - lr * g`` out itself).  AdamW is for the LMs
(``launch/steps.make_train_step``).

The optimizers are functional, as in the JAX package: ``init(params)`` and
``update(grads, state, params) -> (new_params, new_state)`` over dicts of
tensors (nested or flat), with no ``torch.optim``, whose AdamW places
``eps`` and the decay differently.  The state's ``step`` is a 0-d int32
tensor on the parameters' device, the moments are float32, and every
update runs under ``torch.no_grad`` in the JAX package's order of
operations: ``m / bc1``, then ``sqrt(v / bc2) + eps``, the weight decay
added to the update, the step in float32 and cast back to the parameter's
dtype.  Schedules map that step tensor to a float32 rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.trees import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


PAPER_LR0 = 0.25
PAPER_LR_DECAY = 0.99


def paper_lr(rnd):
    """lr_r = 0.25 * 0.99^r on Python numbers and numpy arrays."""
    return PAPER_LR0 * PAPER_LR_DECAY ** rnd


def round_lrs(n_rounds: int) -> np.ndarray:
    """[R] float32 lr of each round, computed in float64 on the host and
    then cast, so both packages use bit-identical values."""
    return np.float32(paper_lr(np.arange(n_rounds, dtype=np.float64)))


def _lr_fn(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr: float | Callable, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            upd = (tree_map(lambda m, g: momentum * m + g, mu, grads)
                   if nesterov else mu)
            new_state = {"step": step + 1, "mu": mu}
        else:
            upd = grads
            new_state = {"step": step + 1}
        new_params = tree_map(lambda p, u: p - lr_t * u, params, upd)
        return new_params, new_state

    return Optimizer(init, update)


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def exponential_decay(init_lr: float, decay: float) -> Callable:
    """Paper schedule: lr_r = init_lr * decay^r (per round)."""
    def fn(step):
        return init_lr * torch.pow(
            torch.tensor(decay, dtype=torch.float32, device=step.device),
            step.float())
    return fn


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    def fn(step):
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak_lr - floor) * (1 + torch.cos(math.pi
                                                              * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"
    lr: float = PAPER_LR0
    lr_decay: float = PAPER_LR_DECAY
    momentum: float = 0.0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95

    def build(self) -> Optimizer:
        if self.name == "sgd":
            sched = (exponential_decay(self.lr, self.lr_decay)
                     if self.lr_decay else self.lr)
            return sgd(sched, momentum=self.momentum)
        if self.name == "adamw":
            return adamw(self.lr, b1=self.b1, b2=self.b2,
                         weight_decay=self.weight_decay)
        raise ValueError(f"unknown optimizer {self.name}")
