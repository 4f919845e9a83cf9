"""ctypes wrapper of the hand-written CUDA attention forward — the
counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention_fwd``, in two variants
chosen by dtype:

- bfloat16 (the LM prefill's path): kernels/csrc/flash_attention_sm90.cu,
  wgmma on the tensor cores with K/V tiles brought by TMA; launches counted
  as ``flash_attention_wgmma``;
- float32: kernels/csrc/flash_attention.cu, FMAs on the CUDA cores (TF32
  would not hold the float32 tolerance); counted as ``flash_attention``.

One launch computes causal (or full) grouped-query attention in the JAX
layout: ``q`` [B, Sq, KV, G, dh], ``k``/``v`` [B, Skv, KV, dh], dh in
{32, 64, 128} -> [B, Sq, KV, G, dh] in q's dtype.  The wrapper checks
device, dtype, shape, contiguity and (bfloat16) 16-byte alignment,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails; nothing falls back to the other variant.  It takes CUDA
tensors only; the plain version is ``kernels/ref.flash_attention_ref``, and
kernels/ops.py routes between the two by device.

``launch_counts`` counts the launches of each variant (reset it with
:func:`reset_launch_counts`), so a run can show which kernel it went
through.
"""

from __future__ import annotations

import ctypes

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


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _launcher(source: str):
    """The C entry point ``<source>_launch`` of the library built from
    ``csrc/<source>.cu``; both variants take the same arguments."""
    lib = _build.load(source)
    fn = getattr(lib, f"{source}_launch")
    if not getattr(lib, "_repro_ready", False):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib._repro_ready = True
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """The attention forward on the card; contract of
    ``kernels/ref.flash_attention_ref`` without its extra masks."""
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
    grid_ok = (-(-sq * g // WGMMA_ROWS) <= 65535 and b * kv < 2 ** 31
               if wgmma else b * kv <= 65535 and sq * g < 2 ** 31)
    if min(b, sq, skv, kv, g) < 1 or not grid_ok:
        raise ValueError(f"sizes out of range: B={b}, Sq={sq}, Skv={skv}, "
                         f"KV={kv}, G={g}")
    out = torch.empty_like(q)
    if wgmma and any(x.data_ptr() % 16 for x in (q, k, v, out)):
        raise ValueError("the bfloat16 kernel needs 16-byte aligned q, k "
                         "and v (TMA and 16-byte loads)")
    source, name = VARIANTS[q.dtype]
    err = _launcher(source)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        kv, g, dh, int(causal), dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out
