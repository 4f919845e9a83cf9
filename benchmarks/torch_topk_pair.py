"""Versions of the local top-S kernel side by side on one card.

    python3 benchmarks/torch_topk_pair.py SRC.cu [SRC2.cu ...] [--out FILE] \\
        [--shape G,P,C,S ...]

from the root of a checkout.  Each SRC is a CUDA file with the C entry point
of ``src/repro_torch/kernels/csrc/topk_slots.cu`` (``topk_slots_launch``),
e.g. the file of this checkout and a copy of another commit's.  A source
whose entry point takes the launch plan (cluster, chunk, staged, words,
threads after S) gets ``kernels/topk_slots.plan``'s; one that takes score,
valid, vals, slots, rows, C, S and the stream plans for itself.  The script
builds every source with nvcc (all at once, ``-Xptxas -v``) and prints each
kernel's registers, stack and spills.  Then it holds every version bitwise
against the plain version (``kernels/ref.local_topk_ref``) on
``chip_smoke.py`` phase 9's cases, and times the four shapes below (and
each ``--shape``) in alternation (A B ... B A, twice): CUDA events over
back-to-back launches into outputs allocated once, and the device time per
launch by torch.profiler, each version's min-max over its four timings,
beside ``torch.topk`` on the masked scores and the bound (and the events
time of this checkout's wrapper, ``local_topk_cuda``, argument checks and
output allocation included).  The last line is a JSON object with every
timing (also written to FILE).  It exits non-zero if a build fails or a
version disagrees; a version whose launch refuses a case (an older
kernel's row limit) is reported as refusing it.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels import topk_slots  # noqa: E402

# (G, P, C, S): phase 10's shapes at K = 10^4 and 10^6, one grid point at
# K = 10^6, and the step-count stress S = 64
TIMED = [(8, 4, 1_000, 5), (2, 8, 100_000, 5), (1, 8, 100_000, 5),
         (2, 2, 4_096, 64)]


def takes_plan(src: str) -> bool:
    """Whether the source's entry point takes the launch plan."""
    text = Path(src).read_text()
    head = text[text.index("int topk_slots_launch("):]
    return "int cluster" in head[:head.index(")")]


def launcher(lib, planned: bool):
    fn = lib.topk_slots_launch
    ints = [ctypes.c_int] * (7 if planned else 2)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(score, valid, s, vals, slots):
        c = score.shape[-1]
        rows = score.numel() // c
        p = topk_slots.plan(rows, c)
        extra = ((p.cluster, p.chunk, p.staged, p.words, p.threads)
                 if planned else ())
        err = fn(score.data_ptr(), valid.data_ptr(), vals.data_ptr(),
                 slots.data_ptr(), rows, c, s, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"topk_slots launch failed: CUDA error {err}")
        return vals, slots
    return run


def outputs(score, s):
    shape = (*score.shape[:-1], s)
    return (torch.empty(shape, dtype=torch.float32, device=score.device),
            torch.empty(shape, dtype=torch.int32, device=score.device))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="G,P,C,S", help="time this shape too")
    args = ap.parse_args()
    timed = TIMED + [tuple(int(v) for v in sh.split(",")) for sh in args.shape]
    if not torch.cuda.is_available() or not args.sources:
        sys.exit(__doc__)
    print(cs.card_name_and_power())
    record: list = []
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        runs = [launcher(lib, takes_plan(src)) for lib, src in zip(
            kp.build(args.sources, Path(tmp), "t"), args.sources)]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        cases = [(g, p, c, s, kind) for g, p, c, s, kind in cs.TOPK_CASES] + [
            (g, p, c, s, "path") for g, p, c, s in timed
            if (g, p, c, s, "path") not in cs.TOPK_CASES]
        # rows past PR 13's longest last: its launch refuses them and leaves
        # the error for its next call to report
        cases.sort(key=lambda case: case[2] > 1_851_392)
        for g, p, c, s, kind in cases:
            score, valid = cs.topk_inputs(g, p, c, kind, gen, s)
            pv, ps = ref.local_topk_ref(score, valid, s)
            line = (f"topk G={g} P={p} C={c} S={s} {kind} (cluster "
                    f"{topk_slots.plan(g * p, c).cluster}):")
            for i, run in enumerate(runs):
                try:
                    vals, slots = run(score, valid, s, *outputs(score, s))
                except RuntimeError as e:   # a row longer than it takes
                    line += f" t{i} refuses ({e})"
                    continue
                torch.cuda.synchronize()
                same = torch.equal(slots, ps) and cs.bits_equal(vals, pv)
                ok &= same
                line += f" t{i} {'equal' if same else 'DIFFERS'}"
            if kind == "path" and (g, p, c, s) in timed:
                outs = [outputs(score, s) for _ in runs]
                ev = kp.alternate(runs, lambda i: cs.time_ms(
                    lambda: runs[i](score, valid, s, *outs[i]), 200))
                dv = kp.alternate(runs, lambda i: cs.profiled_kernel_ms(
                    lambda: runs[i](score, valid, s, *outs[i]), 50,
                    "topk_slots_kernel"))
                masked = torch.where(valid, score, float("-inf"))
                lms = cs.time_ms(lambda: masked.topk(s, dim=-1), 200)
                wms = cs.time_ms(lambda: topk_slots.local_topk_cuda(
                    score, valid, s), 200)
                bms, _ = cs.topk_bound(g * p, c, s)
                line += (f" | events {kp.spans('t', ev)} ms; device "
                         f"{kp.spans('t', dv)} ms; this checkout's wrapper "
                         f"{wms:.4f} ms; torch.topk {lms:.4f} ms; bound "
                         f"{bms:.6f} ms")
                record.append(dict(g=g, p=p, c=c, s=s, events_ms=ev,
                                   device_ms=dv, wrapper_ms=wms,
                                   library_ms=lms, bound_ms=bms))
            print(line, flush=True)
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
