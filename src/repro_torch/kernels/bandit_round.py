"""ctypes wrappers of the hand-written CUDA bandit-round kernel
(kernels/csrc/bandit_round.cu) — the counterparts of the JAX package's
Pallas kernels ``repro.kernels.bandit_round.bandit_round_pallas`` and
``bandit_round_pallas_sampled``.

One launch runs one whole round (score -> select -> schedule -> observe)
for every grid point of a [G]-batched state, one thread block per grid
point, and updates the state in place: only the selected rows (and, for
discounted UCB, the decayed ``disc_*`` rows) are written, so a round moves
O(C + S) bytes per grid point instead of the whole state.  The wrappers
check device, dtype, shape and contiguity, allocate the outputs, launch on
PyTorch's current stream and raise if the launch fails.  They take CUDA
tensors only; the plain versions are in kernels/ref.py, and kernels/ops.py
routes between the two by device.

``launch_counts`` counts the launches of each variant (reset it with
:func:`reset_launch_counts`), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import bandit
from repro_torch.kernels import _build
from repro_torch.sim import truncnorm

launch_counts = {"bandit_round": 0, "bandit_round_sampled": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int32
_F = ctypes.c_float


class _RoundArgs(ctypes.Structure):
    """Mirror of ``struct RoundArgs`` in csrc/bandit_round.cu."""

    _fields_ = (
        [(n, _P) for n in bandit.STATE_FIELDS]
        + [(n, _P) for n in ("cand", "t_ud", "t_ul", "u2", "theta_mu",
                             "gamma_mu", "n_samples", "eta", "rand",
                             "fault_u", "sel", "round_time", "flags")]
        + [(n, _I) for n in ("g", "k", "c", "w", "s", "policy", "fluctuate",
                             "failure", "has_fault")]
        + [(n, _F) for n in ("hyper", "decay", "model_bits", "deadline",
                             "p_crash", "p_churn", "p_corrupt", "p_lo",
                             "p_span", "sqrt2")]
        + [("erfinv_lt5", _F * 9), ("erfinv_ge5", _F * 9)])


def _lib():
    lib = _build.load("bandit_round")
    if not getattr(lib, "_repro_ready", False):
        lib.bandit_round_launch.argtypes = [ctypes.POINTER(_RoundArgs),
                                            ctypes.c_int, ctypes.c_void_p]
        lib.bandit_round_launch.restype = ctypes.c_int
        lib.bandit_round_max_c.restype = ctypes.c_int
        lib.bandit_round_max_s.restype = ctypes.c_int
        lib.bandit_round_args_size.restype = ctypes.c_int
        if lib.bandit_round_args_size() != ctypes.sizeof(_RoundArgs):
            raise RuntimeError("RoundArgs layout differs between "
                               "bandit_round.cu and its wrapper")
        lib._repro_ready = True
    return lib


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def _prepare(sampled, state, cand_idx, *, t_ud=None, t_ul=None, u2=None,
            theta_mu=None, gamma_mu=None, n_samples=None, eta=None,
            model_bits=0.0, fluctuate=True, rand, hyper, policy, s_round,
            decay, fault, deadline, fault_u):
    device = state.n_sel.device
    if device.type != "cuda":
        raise ValueError("the CUDA bandit-round kernel takes CUDA tensors; "
                         "kernels/ops.py routes CPU tensors to the plain "
                         "version")
    bandit.check_policy(policy)
    g, k = state.n_sel.shape
    w = state.hist_ud.shape[2]
    c = cand_idx.shape[1] if cand_idx.dim() == 2 else -1
    lib = _lib()
    if not 0 < s_round <= lib.bandit_round_max_s():
        raise ValueError(f"s_round={s_round} outside (0, "
                         f"{lib.bandit_round_max_s()}]")
    if c > lib.bandit_round_max_c():
        raise ValueError(f"{c} candidates exceed the kernel's ceiling of "
                         f"{lib.bandit_round_max_c()}")
    f32, i32 = torch.float32, torch.int32
    args = _RoundArgs()
    for name in bandit.STATE_FIELDS:
        x = getattr(state, name)
        shape = {"total": (g,), "disc_total": (g,), "hist_ud": (g, k, w),
                 "hist_ul": (g, k, w)}.get(name, (g, k))
        dtype = i32 if name in ("n_sel", "total", "hist_n", "n_fail") else f32
        setattr(args, name, _check(f"state.{name}", x, shape, dtype, device))
    args.cand = _check("cand_idx", cand_idx, (g, c), i32, device)
    if sampled:
        if fluctuate:
            args.u2 = _check("u2", u2, (g, 2, c), f32, device)
            args.eta = _check("eta", eta, (g,), f32, device)
        args.theta_mu = _check("theta_mu", theta_mu, (g, k), f32, device)
        args.gamma_mu = _check("gamma_mu", gamma_mu, (g, k), f32, device)
        args.n_samples = _check("n_samples", n_samples, (k,), f32, device)
    else:
        args.t_ud = _check("t_ud", t_ud, (g, k), f32, device)
        args.t_ul = _check("t_ul", t_ul, (g, k), f32, device)
    if policy == "random":
        args.rand = _check("rand", rand, (g, k), f32, device)
    failure = deadline is not None
    if failure and fault is not None:
        args.fault_u = _check("fault_u", fault_u, (g, 3, s_round), f32,
                              device)
    sel = torch.empty((g, s_round), dtype=i32, device=device)
    round_time = torch.empty((g,), dtype=f32, device=device)
    flags = torch.empty((g, s_round), dtype=i32, device=device)
    args.sel, args.round_time, args.flags = (
        sel.data_ptr(), round_time.data_ptr(), flags.data_ptr())
    args.g, args.k, args.c, args.w, args.s = g, k, c, w, s_round
    args.policy = bandit.POLICY_IDS[policy]
    args.fluctuate, args.failure = int(fluctuate), int(failure)
    args.has_fault = int(failure and fault is not None)
    args.hyper, args.decay, args.model_bits = hyper, decay, model_bits
    if failure:
        args.deadline = deadline
        if fault is not None:
            args.p_crash, args.p_churn, args.p_corrupt = fault
    args.p_lo = truncnorm.P_LO
    args.p_span = truncnorm.P_HI - truncnorm.P_LO
    args.sqrt2 = truncnorm.SQRT2
    args.erfinv_lt5 = (_F * 9)(*np.float32(truncnorm.ERFINV_W_LT5))
    args.erfinv_ge5 = (_F * 9)(*np.float32(truncnorm.ERFINV_W_GE5))

    stream = torch.cuda.current_stream(device).cuda_stream
    name = "bandit_round_sampled" if sampled else "bandit_round"
    out = (state, sel, round_time, flags) if failure else (
        state, sel, round_time)

    def launch():
        err = lib.bandit_round_launch(ctypes.byref(args), int(sampled),
                                      stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        launch_counts[name] += 1
        return out
    return launch


def bandit_round_launcher(state, cand_idx, t_ud, t_ul, rand, hyper, *,
                          policy: str, s_round: int, decay: float = 1.0,
                          fault: tuple | None = None,
                          deadline: float | None = None, fault_u=None):
    """Check the inputs and return a function that launches the legacy
    kernel on them (and counts the launch).  Each call runs one more round
    on the same state and inputs, in place; it returns
    ``(state, sel, round_time[, flags])``."""
    return _prepare(False, state, cand_idx, t_ud=t_ud, t_ul=t_ul, rand=rand,
                    hyper=hyper, policy=policy, s_round=s_round, decay=decay,
                    fault=fault, deadline=deadline, fault_u=fault_u)


def bandit_round_sampled_launcher(state, cand_idx, u2, rand, theta_mu,
                                  gamma_mu, n_samples, eta, model_bits,
                                  hyper, *, policy: str, s_round: int,
                                  decay: float = 1.0, fluctuate: bool = True,
                                  fault: tuple | None = None,
                                  deadline: float | None = None,
                                  fault_u=None):
    """:func:`bandit_round_launcher` for the sampled kernel."""
    return _prepare(True, state, cand_idx, u2=u2, theta_mu=theta_mu,
                    gamma_mu=gamma_mu, n_samples=n_samples, eta=eta,
                    model_bits=model_bits, fluctuate=fluctuate, rand=rand,
                    hyper=hyper, policy=policy, s_round=s_round, decay=decay,
                    fault=fault, deadline=deadline, fault_u=fault_u)


def bandit_round_cuda(*args, **kw):
    """One round on presampled [G, K] times (the legacy path); contract of
    ``kernels/ref.bandit_round_ref`` except that ``state`` is updated in
    place and returned."""
    return bandit_round_launcher(*args, **kw)()


def bandit_round_sampled_cuda(*args, **kw):
    """One round that draws its candidates' Eq. (8) times in the kernel
    (the streamed-sampling path); contract of
    ``kernels/ref.bandit_round_sampled_ref`` except that ``state`` is
    updated in place and returned."""
    return bandit_round_sampled_launcher(*args, **kw)()
