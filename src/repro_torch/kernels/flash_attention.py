"""ctypes wrapper of the hand-written CUDA attention forward
(kernels/csrc/flash_attention.cu) — the counterpart of the JAX package's
Pallas kernel ``repro.kernels.flash_attention.flash_attention_fwd``.

One launch computes causal (or full) grouped-query attention in the JAX
layout: ``q`` [B, Sq, KV, G, dh], ``k``/``v`` [B, Skv, KV, dh], float32 or
bfloat16, dh in {32, 64, 128} -> [B, Sq, KV, G, dh] in q's dtype.  The
wrapper checks device, dtype, shape and contiguity, allocates the output,
launches on PyTorch's current stream and raises if the launch fails.  It
takes CUDA tensors only; the plain version is
``kernels/ref.flash_attention_ref``, and kernels/ops.py routes between the
two by device.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launch_counts = {"flash_attention": 0}
HEAD_DIMS = (32, 64, 128)


def reset_launch_counts() -> None:
    launch_counts["flash_attention"] = 0


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_ready", False):
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._repro_ready = True
    return lib


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
    if min(b, sq, skv, kv, g) < 1 or b * kv > 65535 or sq * g >= 2 ** 31:
        raise ValueError(f"sizes out of range: B={b}, Sq={sq}, Skv={skv}, "
                         f"KV={kv}, G={g}")
    out = torch.empty_like(q)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        kv, g, dh, int(causal), dh ** -0.5, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["flash_attention"] += 1
    return out
