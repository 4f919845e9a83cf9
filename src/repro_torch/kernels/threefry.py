"""ctypes wrapper of the hand-written CUDA Threefry-2x32 kernel
(kernels/csrc/threefry.cu): ``jax.random``'s counter-based generator on the
card.  It replaces no TPU kernel; the port adds it so that its sweeps draw
the JAX package's random numbers from the same seeds.

One launch hashes N keys over n counters from an offset (plus a per-row
offset, for ``fold_in``) and writes raw 32-bit bits, (y0, y1) key pairs or
float32 uniforms on [minval, maxval), as ``kernels/ref.threefry_ref``
computes them.  The wrapper checks device, dtype, shape and contiguity,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails.  It takes CUDA tensors only; kernels/ops.py routes CPU
tensors to the plain version.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import THREEFRY_OUTS, uniform_affine

launch_counts = {"threefry": 0}


def reset_launch_counts() -> None:
    launch_counts["threefry"] = 0


@functools.cache
def _launcher():
    """``threefry_launch`` with its argument types, set once at load."""
    fn = _build.load("threefry").threefry_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def threefry_cuda(keys: torch.Tensor, n: int, *, offset: int = 0,
                  row_offsets: torch.Tensor | None = None, out: str = "bits",
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Threefry-2x32 on the card; contract of ``kernels/ref.threefry_ref``."""
    if out not in THREEFRY_OUTS:
        raise ValueError(f"out must be one of {THREEFRY_OUTS}, got {out!r}")
    if (not isinstance(keys, torch.Tensor) or keys.dtype != torch.int32
            or keys.shape[-1:] != (2,)):
        raise ValueError("keys must be an int32 [N, 2] tensor")
    dev = keys.get_device()
    if dev < 0:
        raise ValueError("the CUDA threefry kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    keys = keys.reshape(-1, 2).contiguous()
    n_keys = keys.shape[0]
    if not (0 < n_keys and 0 < n and n_keys * n < 2 ** 62):
        raise ValueError(f"N={n_keys} keys x n={n} counters out of range")
    if not 0 <= offset < 2 ** 64:
        raise ValueError(f"offset {offset} is no 64-bit counter")
    ro_ptr = None
    if row_offsets is not None:
        row_offsets = row_offsets.reshape(-1).to(torch.int64).contiguous()
        if row_offsets.shape[0] != n_keys or row_offsets.get_device() != dev:
            raise ValueError(f"row_offsets must be [{n_keys}] on "
                             f"{keys.device}")
        ro_ptr = row_offsets.data_ptr()
    shape = (n_keys, n, 2) if out == "pairs" else (n_keys, n)
    res = torch.empty(shape, device=keys.device,
                      dtype=torch.float32 if out == "uniform"
                      else torch.int32)
    lo, span = uniform_affine(minval, maxval)
    err = _launcher()(keys.data_ptr(), ro_ptr, n_keys, n, offset,
                      THREEFRY_OUTS.index(out), lo, span, res.data_ptr(),
                      torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["threefry"] += 1
    return res
