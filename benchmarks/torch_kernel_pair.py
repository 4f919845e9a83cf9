"""Versions of the FedAvg-combine and bandit-round kernels side by side on
one card.

    python3 benchmarks/torch_kernel_pair.py [--fedavg SRC ...] \\
        [--round SRC ...] [--out FILE]

from the root of a checkout.  Each ``--fedavg`` SRC is a CUDA file with the
C entry point of ``src/repro_torch/kernels/csrc/fedavg.cu``
(``fedavg_combine_launch``), each ``--round`` SRC one with that of
``bandit_round.cu`` (``bandit_round_launch`` on the same ``RoundArgs``),
e.g. the file of this checkout and a copy of another commit's.  The script
builds every source with nvcc (all at once, ``-Xptxas -v``) and prints each
kernel's registers, stack and spills.  Then it holds every version against
its plain version (``kernels/ref.py``) as ``chip_smoke.py`` phases 2 and 6
do (the combine bitwise, the round exact in selections and flags, rtol 1e-6
in state), and times the main paths' shapes in alternation (A B ... B A,
twice): CUDA events over back-to-back launches and the device time per
launch by torch.profiler, each version's min-max over its four timings.
The last line is a JSON object with every timing (also written to FILE).
It exits non-zero if a build fails or a version disagrees.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.kernels import bandit_round as cuda_round  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.sim.engine import EnvArrays  # noqa: E402
from repro_torch.sim.scenarios import get_scenario  # noqa: E402

# (dtype, G, C, N): the combine's timed shapes, chip_smoke.py phase 6's and
# C between them
FEDAVG_TIMED = [(dt, g, c, cs.N_CNN) for dt in (torch.float32, torch.bfloat16)
                for g, c in ((1, 5), (1, 10), (1, 20), (1, 100), (2, 5))]
# (variant sampled?, scenario, G, K, C, S): the round's timed shapes
ROUND_TIMED = [(False, "paper-baseline", 24, 100, 10, 5),
               (True, "paper-baseline", 8, 10_000, 1_000, 5),
               (True, "paper-baseline", 8, 10_000, 1_000, 50),
               (True, "metro-congestion", 1, 100_000, 10_000, 5),
               (True, "paper-baseline", 8, 10_000, 257, 5)]
ROUND_CHECKED = [(sampled, scen, 4 if g > 4 else g, k, c, s)
                 for sampled, scen, g, k, c, s in ROUND_TIMED] + [
    (sampled, "paper-baseline", 4, 10_000, c, s)
    for sampled in (False, True) for c, s in cs.ROUND_EDGES] + [
    (sampled, "paper-baseline", 3, 999, 100, 5) for sampled in (False, True)]


def build(sources, out_dir: Path, tag: str):
    """One library per source, built in parallel; prints what ptxas says of
    each kernel's registers, stack and spills."""
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / f"{tag}{i}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, src in enumerate(sources)]
    libs = []
    for i, (src, proc) in enumerate(zip(sources, procs)):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{log}")
        print(f"{tag}{i} = {src}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, stack = m.group(1), ("?", "?", "?")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and fn:
                stack = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"  {fn[:60]}: {m.group(1)} registers, stack "
                      f"{stack[0]} B, spill stores {stack[1]} B, loads "
                      f"{stack[2]} B")
                fn = None
        libs.append(ctypes.CDLL(str(out_dir / f"{tag}{i}.so")))
    return libs


def alternate(versions, timer):
    """timer(i) for versions in the order A B ... B A, twice."""
    order = list(range(len(versions)))
    got = {i: [] for i in order}
    for i in (order + order[::-1]) * 2:
        got[i].append(timer(i))
    return got


def spans(label, got):
    return ", ".join(
        f"{label}{i} {min(t):.4f}-{max(t):.4f}" if None not in t
        else f"{label}{i} none" for i, t in got.items())


def fedavg_fn(lib):
    fn = lib.fedavg_combine_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, w):
        g, c, n = x.shape
        out = torch.empty((g, n), dtype=x.dtype, device=x.device)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, c, n,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fedavg launch failed: CUDA error {err}")
        return out
    return run


def fedavg_pairs(libs, record) -> bool:
    runs = [fedavg_fn(lib) for lib in libs]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    ok = True
    cases = [(dt, g, c, n, 0) for dt in (torch.float32, torch.bfloat16)
             for g, c, n in cs.FEDAVG_CASES] + [
        (dt, g, c, n, 1) for dt in (torch.float32, torch.bfloat16)
        for g, c, n in cs.FEDAVG_OFFSET_CASES] + [
        (dt, g, c, n, 0) for dt, g, c, n in FEDAVG_TIMED
        if (g, c, n) not in cs.FEDAVG_CASES]
    for dt, g, c, n, shift in cases:
        buf = torch.randn(shift + g * c * n, generator=gen,
                          device="cuda").to(dt)
        x = buf[shift:].view(g, c, n)
        w = torch.rand((g, c), generator=gen, device="cuda")
        w[:, ::3] = 0.0
        w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
        want = ref.fedavg_combine_ref(x, w)
        line = f"fedavg {str(dt)[6:]} G={g} C={c} N={n} shift={shift}:"
        for i, run in enumerate(runs):
            same = torch.equal(run(x, w), want)
            ok &= same
            line += f" f{i} {'equal' if same else 'DIFFERS'}"
        if (dt, g, c, n) in FEDAVG_TIMED and not shift:
            ev = alternate(runs, lambda i: cs.time_ms(lambda: runs[i](x, w),
                                                      100))
            dv = alternate(runs, lambda i: cs.profiled_kernel_ms(
                lambda: runs[i](x, w), 20, "fedavg_combine_kernel"))
            bms, _ = cs.fedavg_bound(g, c, n, x.element_size())
            line += (f" | events {spans('f', ev)} ms; device "
                     f"{spans('f', dv)} ms; bound {bms:.4f} ms")
            record.append(dict(kernel="fedavg_combine", dtype=str(dt)[6:],
                               g=g, c=c, n=n, events_ms=ev, device_ms=dv,
                               bound_ms=bms))
        print(line, flush=True)
    return ok


class _Lib:
    """One version's library with the calls the round's wrapper makes."""

    def __init__(self, lib):
        self.lib = lib
        lib.bandit_round_launch.argtypes = [
            ctypes.POINTER(cuda_round._RoundArgs), ctypes.c_int,
            ctypes.c_void_p]
        lib.bandit_round_launch.restype = ctypes.c_int
        self.bandit_round_launch = lib.bandit_round_launch
        self.bandit_round_max_s = lib.bandit_round_max_s
        # a version without the call takes every C this script gives it
        self.bandit_round_max_c = getattr(lib, "bandit_round_max_c",
                                          lambda: 1 << 30)


def round_pairs(libs, record) -> bool:
    shims = [_Lib(lib) for lib in libs]
    dev = torch.device("cuda")
    ok = True

    def prepared(i, sampled, state, kw, policy, s, fault):
        cuda_round._lib = lambda: shims[i]         # this version's library
        return cs.call_round(cs.launcher(sampled), state, kw, policy, s,
                             fault, sampled)

    timed = set(ROUND_TIMED)
    for sampled, scen_name, g, k, c, s in ROUND_CHECKED + ROUND_TIMED:
        is_timed = (sampled, scen_name, g, k, c, s) in timed
        scen = get_scenario(scen_name)
        env = EnvArrays.from_scenario(
            scen, scen.build_env(k, np.random.default_rng(0)), dev)
        name = "sampled" if sampled else "legacy"
        where = f"round {name} {scen_name} G={g} K={k} C={c} S={s}"
        ev = {i: [] for i in range(len(shims))}
        dv = {i: [] for i in range(len(shims))}
        for policy in bandit.POLICY_NAMES:
            for failure in ((False,) if is_timed else (False, True)):
                gen = torch.Generator(device=dev)
                gen.manual_seed(k + s + g + 17 * failure)
                state = bandit.BanditState.create(g, k, device=dev)
                plain = (ref.bandit_round_sampled_ref if sampled
                         else ref.bandit_round_ref)
                for _ in range(20):
                    kw, fault = cs.round_inputs(env, scen, g, k, c, s,
                                                policy, sampled, failure, gen)
                    state = cs.call_round(plain, state, kw, policy, s, fault,
                                          sampled)[0]
                kw, fault = cs.round_inputs(env, scen, g, k, c, s, policy,
                                            sampled, failure, gen)
                want = cs.call_round(plain, state.clone(), kw, policy, s,
                                     fault, sampled)
                for i in range(len(shims)):
                    got = prepared(i, sampled, state.clone(), kw, policy, s,
                                   fault)()
                    torch.cuda.synchronize()
                    try:
                        cs.compare(got, want, f"{where} {policy} v{i}")
                    except AssertionError as e:
                        print(f"DIFFERS: {e}", flush=True)
                        ok = False
                if not is_timed:
                    continue
                launches = [prepared(i, sampled, state.clone(), kw, policy,
                                     s, fault) for i in range(len(shims))]
                for fn in launches:
                    for _ in range(20):             # leave the cold start
                        fn()
                e = alternate(launches,
                              lambda i: cs.time_ms(launches[i], 200))
                d = alternate(launches, lambda i: cs.profiled_kernel_ms(
                    launches[i], 50))
                for i in ev:
                    ev[i].append(e[i])
                    dv[i].append(d[i])
        if not is_timed:
            print(f"{where}: checked, 8 policies x deadline off/on", flush=True)
            continue
        # each version's four alternated timings, each the mean over policies
        mean = lambda runs: [None if None in col else float(np.mean(col))
                             for col in zip(*runs)]
        ev = {i: mean(t) for i, t in ev.items()}
        dv = {i: mean(t) for i, t in dv.items()}
        print(f"{where}: events {spans('r', ev)} ms; device "
              f"{spans('r', dv)} ms (means over 8 policies)", flush=True)
        record.append(dict(kernel="bandit_round_sampled" if sampled
                           else "bandit_round", scenario=scen_name, g=g, k=k,
                           c=c, s=s, events_ms=ev, device_ms=dv))
    return ok


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fedavg", nargs="*", default=[])
    ap.add_argument("--round", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available() or not (args.fedavg or args.round):
        sys.exit(__doc__)
    print(cs.card_name_and_power())
    record: list = []
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        f_libs = build(args.fedavg, Path(tmp), "f")
        r_libs = build(args.round, Path(tmp), "r")
        if f_libs:
            ok &= fedavg_pairs(f_libs, record)
        if r_libs:
            ok &= round_pairs(r_libs, record)
    print("every version agrees with its plain version" if ok
          else "FAILED: a version disagrees with its plain version")
    line = json.dumps({"card": cs.card_name_and_power(), "runs": record})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
