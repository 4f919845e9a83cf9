"""ctypes wrapper of the hand-written CUDA naive-UCB score kernel
(kernels/csrc/ucb_score.cu) — the counterpart of the JAX package's Pallas
kernel ``repro.kernels.ucb_score.ucb_scores``.

One launch scores every arm of a [G, K] grid of bandit states: ``sums``
[G, K] float32, ``n_sel`` [G, K] int32 and ``total`` [G] int32 -> [G, K]
float32, as ``kernels/ref.ucb_scores_ref`` computes it.  The wrapper checks
device, dtype, shape and contiguity, allocates the output, launches on
PyTorch's current stream and raises if the launch fails.  It takes CUDA
tensors only; kernels/ops.py routes CPU tensors to the plain version.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

launch_counts = {"ucb_score": 0}


def reset_launch_counts() -> None:
    launch_counts["ucb_score"] = 0


def _lib():
    lib = _build.load("ucb_score")
    if not getattr(lib, "_repro_ready", False):
        lib.ucb_score_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_void_p]
        lib.ucb_score_launch.restype = ctypes.c_int
        lib._repro_ready = True
    return lib


def ucb_scores_cuda(sums: torch.Tensor, n_sel: torch.Tensor,
                    total: torch.Tensor,
                    alpha: float = 1000.0) -> torch.Tensor:
    """The scores on the card; contract of ``kernels/ref.ucb_scores_ref``."""
    if not (isinstance(sums, torch.Tensor) and sums.is_cuda):
        raise ValueError("the CUDA ucb_score kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if sums.dtype != torch.float32 or sums.dim() != 2:
        raise ValueError(f"sums must be float32 [G, K], got {sums.dtype} "
                         f"{tuple(sums.shape)}")
    g, k = sums.shape
    for name, x, shape in (("n_sel", n_sel, (g, k)), ("total", total, (g,))):
        if (not isinstance(x, torch.Tensor) or x.device != sums.device
                or x.dtype != torch.int32 or tuple(x.shape) != shape):
            raise ValueError(f"{name} must be int32 of shape {shape} on "
                             f"{sums.device}")
    if not (sums.is_contiguous() and n_sel.is_contiguous()
            and total.is_contiguous()):
        raise ValueError("sums, n_sel and total must be contiguous")
    if not (0 < g <= 65535 and k > 0):
        raise ValueError(f"G={g} or K={k} out of range")
    out = torch.empty((g, k), dtype=torch.float32, device=sums.device)
    lib = _lib()
    stream = torch.cuda.current_stream(sums.device).cuda_stream
    err = lib.ucb_score_launch(sums.data_ptr(), n_sel.data_ptr(),
                               total.data_ptr(), out.data_ptr(), g, k,
                               float(np.float32(alpha)), stream)
    if err != 0:
        raise RuntimeError(f"ucb_score kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["ucb_score"] += 1
    return out
