"""Versions of the UCB-score kernel, and of its wrapper, side by side on one
card.

    python3 benchmarks/torch_ucb_pair.py SRC.cu [SRC2.cu ...] \\
        [--wrapper WRAPPER.py ...] [--out FILE]

from the root of a checkout.  Each SRC is a CUDA file with the C entry point
of ``src/repro_torch/kernels/csrc/ucb_score.cu`` (``ucb_score_launch``),
e.g. the file of this checkout and another commit's
(``git show <commit>:<path> > build/pair/old.cu``).  The script builds every
source with nvcc (all at once, ``-Xptxas -v``) and prints each kernel's
registers, stack and spills.  Then it holds every version against the plain
version (``kernels/ref.ucb_scores_ref``) within ``chip_smoke.py``'s
``UCB_MAX_ULP`` at phase 9's shapes and pointer offsets, and times phase 9's
shapes in alternation (A B ... B A, twice): CUDA events over back-to-back
launches into an output allocated once, and the device time per launch by
torch.profiler, each version's min-max over its four timings, beside the
plain version and the bound.

Each ``--wrapper`` is a Python file with ``ucb_scores_cuda`` of
``src/repro_torch/kernels/ucb_score.py`` (e.g. another commit's copy); it is
loaded as a module of its own and its calls launch this checkout's kernel,
so the wrappers' events times, paired the same way beside this checkout's
wrapper, differ only in the host work of a call.  The last line is a JSON
object with every timing (also written to FILE).  It exits non-zero if a
build fails or a version disagrees.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "benchmarks")]

import chip_smoke as cs  # noqa: E402
import torch_kernel_pair as kp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ucb_score  # noqa: E402

ALPHA = 1000.0


def launcher(lib):
    fn = lib.ucb_score_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(sums, n, total, out):
        g, k = sums.shape
        err = fn(sums.data_ptr(), n.data_ptr(), total.data_ptr(),
                 out.data_ptr(), g, k, ALPHA,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ucb_score launch failed: CUDA error {err}")
        return out
    return run


def wrapper(path: str, i: int):
    spec = importlib.util.spec_from_file_location(f"ucb_wrapper_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ucb_scores_cuda


def ulp_gap(got, want) -> int:
    return int((got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--wrapper", action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available() or not args.sources:
        sys.exit(__doc__)
    print(cs.card_name_and_power())
    record: list = []
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        runs = [launcher(lib) for lib in
                kp.build(args.sources, Path(tmp), "t")]
        wraps = [wrapper(p, i) for i, p in enumerate(args.wrapper)]
        wraps.append(ucb_score.ucb_scores_cuda)
        print(", ".join(f"w{i} = {p}" for i, p in enumerate(
            args.wrapper + ["this checkout's ucb_score.py"])))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(10)
        for g, k, s_off, n_off in cs.UCB_OFFSET_CASES:
            sums, n, total = cs.ucb_inputs(g, k, gen)
            bs = torch.empty(g * k + s_off, device="cuda")
            bn = torch.empty(g * k + n_off, dtype=torch.int32, device="cuda")
            bs[s_off:], bn[n_off:] = sums.flatten(), n.flatten()
            sums, n = bs[s_off:].view(g, k), bn[n_off:].view(g, k)
            want = ref.ucb_scores_ref(sums, n, total, ALPHA)
            line = f"ucb G={g} K={k} offsets {s_off}, {n_off}:"
            for i, run in enumerate(runs):
                gap = ulp_gap(run(sums, n, total, torch.empty_like(want)),
                              want)
                ok &= gap <= cs.UCB_MAX_ULP
                line += f" t{i} {gap} ulp"
            print(line, flush=True)
        for g, k in cs.UCB_CASES:
            sums, n, total = cs.ucb_inputs(g, k, gen)
            total[0] = 1
            want = ref.ucb_scores_ref(sums, n, total, ALPHA)
            outs = [torch.empty_like(want) for _ in runs]
            line = f"ucb G={g} K={k}:"
            for i, run in enumerate(runs):
                gap = ulp_gap(run(sums, n, total, outs[i]), want)
                ok &= gap <= cs.UCB_MAX_ULP
                line += f" t{i} {gap} ulp"
            ev = kp.alternate(runs, lambda i: cs.time_ms(
                lambda: runs[i](sums, n, total, outs[i]), 200))
            dv = kp.alternate(runs, lambda i: cs.profiled_kernel_ms(
                lambda: runs[i](sums, n, total, outs[i]), 50,
                "ucb_score_kernel"))
            wv = kp.alternate(wraps, lambda i: cs.time_ms(
                lambda: wraps[i](sums, n, total, ALPHA), 200))
            pms = cs.time_ms(lambda: ref.ucb_scores_ref(sums, n, total,
                                                        ALPHA), 10)
            bms = (g * (12 * k + 4)) / cs.HBM_BYTES_PER_S * 1e3
            line += (f" | events {kp.spans('t', ev)} ms; device "
                     f"{kp.spans('t', dv)} ms; wrappers {kp.spans('w', wv)} "
                     f"ms; plain {pms:.4f} ms; bound {bms:.6f} ms")
            print(line, flush=True)
            record.append(dict(g=g, k=k, events_ms=ev, device_ms=dv,
                               wrapper_ms=wv, plain_ms=pms, bound_ms=bms))
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
