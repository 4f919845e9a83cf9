"""Parameter-dict helpers — the port of ``repro.utils.trees`` (``tree_add``,
``tree_sub``, ``tree_scale``, ``tree_zeros_like``, ``tree_axpy``,
``tree_dot``, ``global_norm``, ``tree_weighted_sum``, ``tree_bytes``,
``tree_param_count``, ``tree_cast``) plus ``tree_map``/``tree_leaves`` and
the flat layout the FL engine trains in.

A model's parameters are a ``dict`` of tensors, nested for the LMs (every
dict a node, everything else a leaf, keys in insertion order); the
``tree_*`` helpers take any nesting.  :class:`FlatSpec` fixes an
order and an offset for every leaf, so many models can live as the rows of
one [..., N] float32 buffer: :func:`views` hands out per-leaf views of the
rows (training writes through them), and the FedAvg combine reads the
buffer as it is, with no concatenation.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in its key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` in its key
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y"""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_dot(a, b):
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def global_norm(a):
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(a)))


def tree_weighted_sum(trees: list[dict], weights) -> dict:
    """sum_i w_i * tree_i, left to right: ``acc = x0*w0``, then
    ``acc = acc + xi*wi`` (the FedAvg primitive)."""
    def comb(*leaves):
        acc = leaves[0] * weights[0]
        for i in range(1, len(leaves)):
            acc = acc + leaves[i] * weights[i]
        return acc
    return tree_map(comb, *trees)


def tree_bytes(tree: dict) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_param_count(tree: dict) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_cast(a, dtype):
    """Floating leaves cast to ``dtype``; the rest as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Names, shapes and offsets of a parameter dict's leaves in a flat
    vector."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]

    @staticmethod
    def of_tree(tree: dict) -> "FlatSpec":
        """The layout of ``tree``'s leaves, in its key order."""
        shapes = tuple(tuple(x.shape) for x in tree.values())
        sizes = [math.prod(s) for s in shapes]
        offsets = [0]
        for s in sizes[:-1]:
            offsets.append(offsets[-1] + s)
        return FlatSpec(names=tuple(tree), shapes=shapes,
                        offsets=tuple(offsets))


def flatten(tree: dict, spec: FlatSpec) -> torch.Tensor:
    """One [N] float32 vector of ``tree``'s leaves in ``spec``'s order."""
    return torch.cat([tree[n].reshape(-1).float() for n in spec.names])


def views(buf: torch.Tensor, spec: FlatSpec) -> dict[str, torch.Tensor]:
    """Per-leaf views of a [..., N] buffer: leaf ``n`` is
    ``[..., *shape_n]`` and shares ``buf``'s memory."""
    lead = buf.shape[:-1]
    return {n: buf[..., o:o + math.prod(s)].view(*lead, *s)
            for n, s, o in zip(spec.names, spec.shapes, spec.offsets)}


def unflatten(vec: torch.Tensor, spec: FlatSpec) -> dict[str, torch.Tensor]:
    """A parameter dict (copies) from a [..., N] vector."""
    return {n: v.clone() for n, v in views(vec, spec).items()}
