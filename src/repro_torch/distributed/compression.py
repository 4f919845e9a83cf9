"""Upload (client -> server) compression for federated aggregation — the
port of ``repro.distributed.compression``.

  * int8 — per-tensor absmax scaling, 4x fewer collective bytes than f32;
  * topk — magnitude top-k with error feedback (DGC), k = ratio * n.

The arithmetic is the JAX package's: ``absmax + 1e-12``, ``scale =
absmax / 127`` rounded once (``core/bandit.fdiv``), ``torch.round`` (half
to even, as ``jnp.round``) and a clip to [-127, 127]; the top-k of |x|
goes through the tie-safe ``core/bandit.top_k`` (the lower index first
among equal magnitudes, as ``lax.top_k``), never bare ``torch.topk``.  So
on the same float32 inputs the int8 codes, scales and top-k indices are
the JAX package's bitwise.  Trees are dicts of tensors (nested or flat).
"""

from __future__ import annotations

import torch

from repro_torch.core.bandit import fdiv, top_k
from repro_torch.utils.trees import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# int8 absmax quantization
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax-quantize ``x`` to int8: returns (q int8 of ``x``'s shape, 0-d
    float32 scale) with x ~= q * scale."""
    absmax = x.abs().max() + 1e-12
    scale = fdiv(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: q int8 * scale -> float32."""
    return q.float() * scale


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize ``x`` (what the receiver reconstructs)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s).to(x.dtype)


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback (DGC)
# ---------------------------------------------------------------------------

def topk_count(n: int, ratio: float) -> int:
    """k = max(1, int(n * ratio)), the entries top-k keeps of n."""
    return max(1, int(n * ratio))


def topk_compress(x: torch.Tensor, ratio: float
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Keep the k = ratio * n largest-|.| entries of ``x``: returns ([k]
    values, [k] int32 flat indices, k), the indices by magnitude
    descending, ties to the lower index."""
    flat = x.reshape(-1)
    k = topk_count(flat.shape[0], ratio)
    idx = top_k(flat.abs().float(), k)
    return flat[idx], idx.to(torch.int32), k


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, n: int,
                    shape) -> torch.Tensor:
    """Scatter ([k] values, [k] flat indices) back into a dense ``shape``
    tensor of ``n`` elements (zeros elsewhere)."""
    out = vals.new_zeros(n)
    out[idx.long()] = vals
    return out.reshape(shape)


def topk_roundtrip(x: torch.Tensor, ratio: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed view of x, residual error feedback)."""
    vals, idx, _ = topk_compress(x, ratio)
    approx = topk_decompress(vals, idx, x.numel(), x.shape)
    return approx, x - approx


def tree_int8_roundtrip(tree):
    """:func:`int8_roundtrip` applied leaf-wise."""
    return tree_map(int8_roundtrip, tree)


def tree_topk_roundtrip(tree, ratio: float, error_state=None):
    """Error-feedback form: compress (delta + carried error), return
    (approx tree, new error state)."""
    if error_state is None:
        error_state = tree_map(torch.zeros_like, tree)
    corrected = tree_map(torch.add, tree, error_state)
    approx = tree_map(lambda x: topk_roundtrip(x, ratio)[0], corrected)
    err = tree_map(torch.sub, corrected, approx)
    return approx, err


def compression_bytes(tree, method: str, ratio: float = 0.01) -> int:
    """Transport bytes for one client's update under each method."""
    leaves = tree_leaves(tree)
    n = sum(x.numel() for x in leaves)
    if method == "none":
        return 4 * n
    if method == "int8":
        return n + 4 * len(leaves)
    if method == "topk":
        return 8 * sum(topk_count(x.numel(), ratio) for x in leaves)
    raise ValueError(method)
