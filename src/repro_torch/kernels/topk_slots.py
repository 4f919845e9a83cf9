"""ctypes wrapper of the hand-written CUDA local top-S kernel
(kernels/csrc/topk_slots.cu) — the counterpart of the JAX package's Pallas
kernel ``repro.kernels.bandit_round.topk_slots_pallas``.

One launch ranks every row of a [..., C] score tensor (the segmented
round's [G, P, C] per-shard candidate scores), one thread block per row,
and returns ``(vals [..., S] f32, slots [..., S] int32)`` in the order of
``kernels/ref.local_topk_ref``.  The wrapper checks device, dtype, shape
and contiguity, allocates the outputs, launches on PyTorch's current stream
and raises if the launch fails.  It takes CUDA tensors only; kernels/ops.py
routes CPU tensors to the plain version.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# usable shared memory of one Hopper thread block: the picked-slot bitmap
# (C bits) must fit
_SMEM_LIMIT = 232448 - 1024

launch_counts = {"topk_slots": 0}


def reset_launch_counts() -> None:
    launch_counts["topk_slots"] = 0


def _lib():
    lib = _build.load("topk_slots")
    if not getattr(lib, "_repro_ready", False):
        lib.topk_slots_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.topk_slots_launch.restype = ctypes.c_int
        lib.topk_slots_smem_bytes.argtypes = [ctypes.c_int]
        lib.topk_slots_smem_bytes.restype = ctypes.c_size_t
        lib._repro_ready = True
    return lib


def local_topk_cuda(score: torch.Tensor, valid: torch.Tensor,
                    s_round: int):
    """The local top-S on the card; contract of
    ``kernels/ref.local_topk_ref``."""
    if not (isinstance(score, torch.Tensor) and score.is_cuda):
        raise ValueError("the CUDA topk_slots kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    if score.dtype != torch.float32 or score.dim() < 1:
        raise ValueError(f"score must be float32 [..., C], got {score.dtype} "
                         f"{tuple(score.shape)}")
    if (not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool
            or valid.device != score.device or valid.shape != score.shape):
        raise ValueError(f"valid must be bool of shape {tuple(score.shape)} "
                         f"on {score.device}")
    if not (score.is_contiguous() and valid.is_contiguous()):
        raise ValueError("score and valid must be contiguous")
    c = score.shape[-1]
    rows = score.numel() // max(c, 1)
    if c < 1 or rows < 1 or s_round < 1:
        raise ValueError(f"empty rows or s_round={s_round} < 1")
    lib = _lib()
    if lib.topk_slots_smem_bytes(c) > _SMEM_LIMIT:
        raise ValueError(f"C={c} exceeds the kernel's shared-memory bitmap "
                         f"of {_SMEM_LIMIT} bytes")
    lead = score.shape[:-1]
    vals = torch.empty((*lead, s_round), dtype=torch.float32,
                       device=score.device)
    slots = torch.empty((*lead, s_round), dtype=torch.int32,
                        device=score.device)
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = lib.topk_slots_launch(score.data_ptr(), valid.data_ptr(),
                                vals.data_ptr(), slots.data_ptr(), rows, c,
                                s_round, stream)
    if err != 0:
        raise RuntimeError(f"topk_slots kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["topk_slots"] += 1
    return vals, slots
