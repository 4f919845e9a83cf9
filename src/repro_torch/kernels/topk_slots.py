"""ctypes wrapper of the hand-written CUDA local top-S kernel
(kernels/csrc/topk_slots.cu) — the counterpart of the JAX package's Pallas
kernel ``repro.kernels.bandit_round.topk_slots_pallas``.

One launch ranks every row of a [..., C] score tensor (the segmented
round's [G, P, C] per-shard candidate scores), each row split over a
thread-block cluster of :func:`plan`'s size, and returns
``(vals [..., S] f32, slots [..., S] int32)`` in the order of
``kernels/ref.local_topk_ref``.  The wrapper checks device, dtype, shape
and contiguity, allocates both outputs as one buffer, launches on
PyTorch's current stream and raises if the launch fails.  It takes CUDA
tensors only; kernels/ops.py routes CPU tensors to the plain version.

``launch_counts`` counts the launches (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.  :func:`plan` decides how a launch cuts its rows (cluster size,
chunk, staged keys, threads, shared memory) and the wrapper hands it to the
kernel, whose launch checks only that the plan keeps to the row and to
shared memory; so the CPU tests can check every plan without the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# limits of csrc/topk_slots.cu
MAX_THREADS = 1024           # kMaxThreads
MAX_CLUSTER = 16             # kMaxCluster: blocks a row is split over
SMEM_BUDGET = 232448 - 9216  # kSmemBudget: a block's dynamic shared memory
# the plan's own choices
MIN_THREADS = 128            # threads a block, at least
PER_THREAD = 16              # entries a thread stages, while threads grow
TARGET_BLOCKS = 256          # blocks the split aims at (two an SM)
MIN_CHUNK = 4096             # no chunk is cut shorter
# threads of a split launch, at most: on an H100 a launch of 131,072
# threads in clusters of 8 or 16 did not fit the card at once and ran in
# two waves, twice the time of 65,536
MAX_GRID_THREADS = 65536
# the longest row: sixteen chunks whose pick bitmaps fill the budget
MAX_C = MAX_CLUSTER * 32 * (SMEM_BUDGET // 4)

launch_counts = {"topk_slots": 0}


def reset_launch_counts() -> None:
    launch_counts["topk_slots"] = 0


class Plan(NamedTuple):
    cluster: int    # blocks a row is split over (a thread-block cluster)
    chunk: int      # entries a block takes (the last block may take fewer)
    staged: int     # of which keys held in shared memory; the rest stream
    words: int      # bitmap words of the streamed entries' picks
    threads: int    # threads a block
    smem: int       # dynamic shared-memory bytes a block


@functools.lru_cache(maxsize=256)
def plan(rows: int, c: int) -> Plan:
    """How the kernel cuts ``rows`` rows of ``c`` entries.  Enough blocks a
    row to cover the SMs (``TARGET_BLOCKS``), or to stage the row's keys,
    up to ``MAX_CLUSTER``, and no chunk under ``MIN_CHUNK`` entries; a chunk
    whose keys outgrow ``SMEM_BUDGET`` keeps a bitmap of its streamed
    entries and stages what fits beside it (``staged < 0``: C too large).
    Threads: a power of two from ``MIN_THREADS`` giving each at most
    ``PER_THREAD`` entries, up to ``MAX_THREADS``; a split launch that
    can fit the card at once is held to ``MAX_GRID_THREADS``."""
    cover = -(-TARGET_BLOCKS // rows)
    fit = -(-4 * c // SMEM_BUDGET)
    b = max(1, min(max(cover, fit), MAX_CLUSTER, c // MIN_CHUNK))
    chunk = -(-c // b)
    if 4 * chunk <= SMEM_BUDGET:
        staged, words = chunk, 0
    else:
        words = -(-chunk // 32)
        staged = (SMEM_BUDGET - 4 * words) // 4
    t = MIN_THREADS
    while t < MAX_THREADS and t * PER_THREAD < chunk:
        t *= 2
    while (b > 1 and rows * b <= TARGET_BLOCKS and t > MIN_THREADS
           and rows * b * t > MAX_GRID_THREADS):
        t //= 2
    return Plan(b, chunk, staged, words, t, 4 * (words + staged))


def _lib():
    lib = _build.load("topk_slots")
    if not getattr(lib, "_repro_ready", False):
        lib.topk_slots_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        lib.topk_slots_launch.restype = ctypes.c_int
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
    dev = score.get_device()
    if (not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool
            or valid.get_device() != dev or valid.shape != score.shape):
        raise ValueError(f"valid must be bool of shape {tuple(score.shape)} "
                         f"on {score.device}")
    if not (score.is_contiguous() and valid.is_contiguous()):
        raise ValueError("score and valid must be contiguous")
    c = score.shape[-1]
    rows = score.numel() // max(c, 1)
    if c < 1 or rows < 1 or s_round < 1:
        raise ValueError(f"empty rows or s_round={s_round} < 1")
    if c > MAX_C:
        raise ValueError(f"C={c} exceeds the kernel's longest row, {MAX_C}")
    p = plan(rows, c)
    out = score.new_empty((2, *score.shape[:-1], s_round))
    ptr = out.data_ptr()
    err = _lib().topk_slots_launch(
        score.data_ptr(), valid.data_ptr(), ptr, ptr + 4 * rows * s_round,
        rows, c, s_round, p.cluster, p.chunk, p.staged, p.words, p.threads,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"topk_slots kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["topk_slots"] += 1
    return out[0], out[1].view(torch.int32)
