"""Parameter-dict helpers — the port of ``repro.utils.trees``
(``tree_weighted_sum``, ``tree_bytes``, ``tree_param_count``) plus the
flat layout the FL engine trains in.

A model's parameters are a ``dict`` of tensors.  :class:`FlatSpec` fixes an
order and an offset for every leaf, so many models can live as the rows of
one [..., N] float32 buffer: :func:`views` hands out per-leaf views of the
rows (training writes through them), and the FedAvg combine reads the
buffer as it is, with no concatenation.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def tree_weighted_sum(trees: list[dict], weights) -> dict:
    """sum_i w_i * tree_i, left to right: ``acc = x0*w0``, then
    ``acc = acc + xi*wi`` (the FedAvg primitive)."""
    def comb(name):
        acc = trees[0][name] * weights[0]
        for i in range(1, len(trees)):
            acc = acc + trees[i][name] * weights[i]
        return acc
    return {name: comb(name) for name in trees[0]}


def tree_bytes(tree: dict) -> int:
    return sum(x.numel() * x.element_size() for x in tree.values())


def tree_param_count(tree: dict) -> int:
    return sum(x.numel() for x in tree.values())


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
