"""ctypes wrapper of the hand-written CUDA FedAvg combine
(kernels/csrc/fedavg.cu) — the counterpart of the JAX package's Pallas
kernel ``repro.kernels.fedavg.fedavg_combine``.

One launch combines every grid point's client rows: ``stacked`` [G, C, N]
(or [C, N]) float32 or bfloat16, ``weights`` [G, C] (or [C]) float32 ->
[G, N] (or [N]) in the input's dtype, accumulated in float32 left to right
over C.  The wrapper checks device, dtype, shape and contiguity, allocates
the output, launches on PyTorch's current stream and raises if the launch
fails.  It takes CUDA tensors only; the plain version is
``kernels/ref.fedavg_combine_ref``, and kernels/ops.py routes between the
two by device.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.  :func:`copy_plan` mirrors the kernel's bulk-copy arithmetic
(``plan_chunk`` in the source) so that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# constants of csrc/fedavg.cu
ROW_BYTES = 8192               # kRowBytes: one row's chunk of a tile
SLOT_BYTES = ROW_BYTES + 128   # kSlotBytes: its 128-byte aligned superset

launch_counts = {"fedavg_combine": 0}


def reset_launch_counts() -> None:
    launch_counts["fedavg_combine"] = 0


def copy_plan(base: int, g: int, c: int, n: int, itemsize: int) -> dict:
    """How the kernel's bulk-copy path (bfloat16, or float32 with more than
    32 rows) brings a contiguous [g, c, n] tensor of ``itemsize`` bytes an
    element, whose data starts at byte address ``base``, to shared memory:
    one entry per row chunk (grid point, row, tile of
    ``ROW_BYTES // itemsize`` elements), as numpy int64 arrays.

    ``elem``/``len``: the chunk's first flat element and its length;
    ``src``/``bytes``: the bulk copy's global byte address and size (no
    copy when 0), ``dst``: its byte offset in the row's slot; ``off``: the
    slot element where the chunk's element 0 sits; elements ``[lo, hi)`` of
    the chunk are read from the slot, the others from global memory.  The
    copy is the chunk's 128-byte aligned superset clamped to
    ``[align_up(base), align_down(end))``.  Mirrors ``plan_chunk`` in
    csrc/fedavg.cu operation for operation."""
    tile = ROW_BYTES // itemsize
    tiles = -(-n // tile)
    row, t = np.divmod(np.arange(g * c * tiles, dtype=np.int64), tiles)
    elem = row * n + t * tile
    length = np.minimum(tile, n - t * tile)
    end = base + g * c * n * itemsize
    sb = base + elem * itemsize
    eb = sb + length * itemsize
    a0, a1 = sb & ~127, (eb + 127) & ~127
    cs = np.maximum(a0, (base + 15) & ~15)
    ce = np.maximum(np.minimum(a1, end & ~15), cs)
    return dict(elem=elem, len=length, src=cs, dst=cs - a0, bytes=ce - cs,
                off=(sb - a0) // itemsize,
                lo=np.where(cs > sb, (cs - sb) // itemsize, 0),
                hi=np.minimum(length,
                              np.where(ce > sb, (ce - sb) // itemsize, 0)))


def _lib():
    lib = _build.load("fedavg")
    if not getattr(lib, "_repro_ready", False):
        lib.fedavg_combine_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.fedavg_combine_launch.restype = ctypes.c_int
        lib.fedavg_combine_max_c.restype = ctypes.c_int
        lib._repro_ready = True
    return lib


def fedavg_combine_cuda(stacked: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The combine on the card; contract of
    ``kernels/ref.fedavg_combine_ref``."""
    if not (isinstance(stacked, torch.Tensor) and stacked.is_cuda):
        raise ValueError("the CUDA fedavg kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stacked must be float32 or bfloat16, got "
                         f"{stacked.dtype}")
    if stacked.dim() not in (2, 3):
        raise ValueError(f"stacked must be [C, N] or [G, C, N], got shape "
                         f"{tuple(stacked.shape)}")
    batched = stacked.dim() == 3
    g, c, n = stacked.shape if batched else (1, *stacked.shape)
    want = (g, c) if batched else (c,)
    if (not isinstance(weights, torch.Tensor)
            or weights.device != stacked.device
            or weights.dtype != torch.float32
            or tuple(weights.shape) != want):
        raise ValueError(f"weights must be float32 of shape {want} on "
                         f"{stacked.device}")
    if not (stacked.is_contiguous() and weights.is_contiguous()):
        raise ValueError("stacked and weights must be contiguous")
    lib = _lib()
    if not 0 < c <= lib.fedavg_combine_max_c():
        raise ValueError(f"C={c} outside (0, {lib.fedavg_combine_max_c()}]")
    if not 0 < g <= 65535 or n < 1:
        raise ValueError(f"G={g} or N={n} out of range")
    out = torch.empty((g, n) if batched else (n,), dtype=stacked.dtype,
                      device=stacked.device)
    err = lib.fedavg_combine_launch(
        stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), g, c, n,
        int(stacked.dtype == torch.bfloat16),
        torch.cuda.current_stream(stacked.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fedavg_combine kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["fedavg_combine"] += 1
    return out
