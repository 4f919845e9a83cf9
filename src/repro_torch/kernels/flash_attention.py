"""ctypes wrapper of the hand-written CUDA attention forward — the
counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention_fwd``, in two variants
chosen by dtype:

- bfloat16 (the LM prefill's path): kernels/csrc/flash_attention_sm90.cu,
  wgmma on the tensor cores with K/V tiles brought by TMA; launches counted
  as ``flash_attention_wgmma``;
- float32: kernels/csrc/flash_attention.cu, 3xTF32 on the tensor cores
  (each operand as tf32 hi + lo, three TF32 products per product, which
  holds the float32 tolerance where one TF32 product does not), wgmma on
  TMA-fed split K/V tiles; counted as ``flash_attention``, one count per
  call for its two launches (the split pass, then the attention kernel).

One call computes causal (or full) grouped-query attention in the JAX
layout: ``q`` [B, Sq, KV, G, dh], ``k``/``v`` [B, Skv, KV, dh], dh in
{32, 64, 128} -> [B, Sq, KV, G, dh] in q's dtype.  ``q_offset`` places
query row i at position q_offset + i, so a causal call masks the keys
j > q_offset + i: a context-parallel shard of the q rows (rows [r·Sq/P,
(r+1)·Sq/P) with all of k and v, models/layers.py) passes q_offset =
r·Sq/P and computes exactly those rows of the unsplit call.  The wrapper checks
device, dtype, shape, contiguity and 16-byte alignment, allocates the
output (and, for float32, the split K/V's scratch, :func:`f32_scratch_shape`),
launches on PyTorch's current stream and raises if the launch fails;
nothing falls back to the other variant or the plain version.  It takes
CUDA tensors only; the plain version is ``kernels/ref.flash_attention_ref``,
and kernels/ops.py routes between the two by device.

``launch_counts`` counts the launches of each variant (reset it with
:func:`reset_launch_counts`), so a run can show which kernel it went
through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launch_counts = {"flash_attention": 0, "flash_attention_wgmma": 0}
HEAD_DIMS = (32, 64, 128)
# dtype -> (source under kernels/csrc/, launch-count name)
VARIANTS = {torch.float32: ("flash_attention", "flash_attention"),
            torch.bfloat16: ("flash_attention_sm90", "flash_attention_wgmma")}
# (position, head) rows a block of the bf16 kernel takes at dh 128 (192 at
# smaller dh); its grid may hold at most 65535 such row tiles
WGMMA_ROWS = 128
# the float32 kernel's tiles by head width, as Shape<DH> in
# csrc/flash_attention.cu: (consumer warpgroups of 64 rows, beside one
# producer warp; keys a K/V tile; ring stages)
F32_TILES = {32: (2, 64, 4), 64: (2, 64, 2), 128: (1, 32, 2)}
F32_KEY_PAD = 64       # kKeyPad: the split K/V's keys, padded to a multiple
F32_SPLIT_KEYS = 32    # kSplitKeys: keys a block of the split pass takes


def f32_rows(dh: int) -> int:
    """(position, head) rows a block of the float32 kernel takes."""
    return 64 * F32_TILES[dh][0]


def f32_key_pad(skv: int) -> int:
    """Skv rounded up to the split K/V's key padding."""
    return -(-skv // F32_KEY_PAD) * F32_KEY_PAD


def f32_scratch_shape(b: int, skv: int, kv: int, dh: int):
    """The float32 kernel's scratch: K_hi, K_lo as [B * KV, Skv_pad, dh] and
    V_hi^T, V_lo^T as [B * KV, dh, Skv_pad], one [4, B * KV, Skv_pad * dh]
    float32 buffer."""
    return (4, b * kv, f32_key_pad(skv) * dh)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@functools.cache
def _launcher(source: str):
    """The C entry point ``<source>_launch`` of the library built from
    ``csrc/<source>.cu``; the float32 one takes the scratch after ``o``."""
    fn = getattr(_build.load(source), f"{source}_launch")
    n_ptr = 5 if source == "flash_attention" else 4
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """The attention forward on the card; contract of
    ``kernels/ref.flash_attention_ref`` with its ``q_offset`` and without
    its other masks (``window``, ``kv_valid_len``)."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (q, k, v)):
        raise ValueError("the CUDA attention kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be [B, Sq, KV, G, dh] and k, v "
                         f"[B, Skv, KV, dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    if tuple(k.shape) != (b, skv, kv, dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be {(b, skv, kv, dh)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.dtype, v.dtype) != (q.dtype, q.dtype) or not (
            q.device == k.device == v.device):
        raise ValueError("q, k and v must share dtype and device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not in {HEAD_DIMS}")
    wgmma = q.dtype == torch.bfloat16
    # float32: the launch refuses too many row tiles itself; the split
    # pass's grid is checked here, before its scratch is allocated
    grid_ok = b * kv < 2 ** 31 and (
        -(-sq * g // WGMMA_ROWS) <= 65535 if wgmma
        else f32_key_pad(skv) // F32_SPLIT_KEYS <= 65535)
    if min(b, sq, skv, kv, g) < 1 or not grid_ok:
        raise ValueError(f"sizes out of range: B={b}, Sq={sq}, Skv={skv}, "
                         f"KV={kv}, G={g}")
    if not 0 <= q_offset < 2 ** 31 - sq:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    out = torch.empty_like(q)
    aligned = (q, k, v, out) if wgmma else (q, out)
    if any(x.data_ptr() % 16 for x in aligned):
        raise ValueError("the attention kernels need 16-byte aligned q and "
                         "output (and, in bfloat16, k and v): TMA and "
                         "16-byte loads")
    source, name = VARIANTS[q.dtype]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if not wgmma:
        scratch = torch.empty(f32_scratch_shape(b, skv, kv, dh),
                              dtype=torch.float32, device=q.device)
        ptrs.append(scratch.data_ptr())
    err = _launcher(source)(
        *ptrs, b, sq, skv, kv, g, dh, int(causal), int(q_offset), dh ** -0.5,
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out
