"""ctypes wrapper of the hand-written CUDA RG-LRU scan
(kernels/csrc/rg_lru.cu) — the counterpart of the JAX package's Pallas
kernel ``repro.kernels.rg_lru.rg_lru_scan``.

One launch runs the linear recurrence y_t = a_t * y_{t-1} + b_t (y_{-1} =
0) over ``a``, ``b`` [B, T, W], float32 or bfloat16 alike, with a float32
carry, and returns y [B, T, W] in a's dtype.  Any T and W: the ragged edge
is masked.  The wrapper checks device, dtype, shape and contiguity,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails.  It takes CUDA tensors only; the plain version is
``kernels/ref.rg_lru_ref``, and kernels/ops.py routes between the two by
device.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launch_counts = {"rg_lru_scan": 0}
# rg_lru_launch(a, b, y, B, T, W, bf16, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reset_launch_counts() -> None:
    launch_counts["rg_lru_scan"] = 0


def _lib():
    lib = _build.load("rg_lru")
    if not getattr(lib, "_repro_ready", False):
        lib.rg_lru_launch.argtypes = _ARGTYPES
        lib.rg_lru_launch.restype = ctypes.c_int
        lib._repro_ready = True
    return lib


def rg_lru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The scan on the card; contract of ``kernels/ref.rg_lru_ref``."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (a, b)):
        raise ValueError("the CUDA RG-LRU kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"a must be float32 or bfloat16, got {a.dtype}")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError("a and b must share dtype and device")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must both be [B, T, W]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    bsz, t, w = a.shape
    if not (0 < bsz <= 65535 and 0 < t < 2 ** 31 and 0 < w < 2 ** 31):
        raise ValueError(f"sizes out of range: B={bsz}, T={t}, W={w}")
    out = torch.empty_like(a)
    err = _lib().rg_lru_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, t, w,
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["rg_lru_scan"] += 1
    return out
