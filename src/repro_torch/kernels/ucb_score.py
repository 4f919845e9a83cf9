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
import functools

import torch

from repro_torch.kernels import _build

launch_counts = {"ucb_score": 0}


def reset_launch_counts() -> None:
    launch_counts["ucb_score"] = 0


@functools.cache
def _launcher():
    """``ucb_score_launch`` with its argument types, set once at load;
    alpha goes as ``ctypes.c_float``, which rounds a Python float to
    float32 as ``np.float32`` does."""
    fn = _build.load("ucb_score").ucb_score_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ucb_scores_cuda(sums: torch.Tensor, n_sel: torch.Tensor,
                    total: torch.Tensor,
                    alpha: float = 1000.0) -> torch.Tensor:
    """The scores on the card; contract of ``kernels/ref.ucb_scores_ref``."""
    if not isinstance(sums, torch.Tensor) or sums.dtype != torch.float32 \
            or sums.dim() != 2:
        raise ValueError(f"sums must be a float32 [G, K] tensor, got "
                         f"{getattr(sums, 'dtype', type(sums))} "
                         f"{tuple(getattr(sums, 'shape', ()))}")
    g, k = sums.shape
    for name, x, shape in (("n_sel", n_sel, (g, k)), ("total", total, (g,))):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or x.shape != shape):
            raise ValueError(f"{name} must be an int32 tensor of shape "
                             f"{shape}")
    dev = sums.get_device()
    if dev < 0:
        raise ValueError("the CUDA ucb_score kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if n_sel.get_device() != dev or total.get_device() != dev:
        raise ValueError(f"n_sel and total must be on {sums.device}")
    if not (sums.is_contiguous() and n_sel.is_contiguous()
            and total.is_contiguous()):
        raise ValueError("sums, n_sel and total must be contiguous")
    if not (0 < g <= 65535 and k > 0):
        raise ValueError(f"G={g} or K={k} out of range")
    out = torch.empty_like(sums)
    err = _launcher()(sums.data_ptr(), n_sel.data_ptr(), total.data_ptr(),
                      out.data_ptr(), g, k, alpha,
                      torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"ucb_score kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["ucb_score"] += 1
    return out
