"""Versions of an attention kernel side by side on one card.

    python3 benchmarks/torch_flash_pair.py SOURCE [SOURCE ...]

from the root of a checkout.  Each SOURCE is a CUDA file with the C entry
point of one of the port's attention kernels: the bfloat16
``flash_attention_sm90_launch`` of
``src/repro_torch/kernels/csrc/flash_attention_sm90.cu``, or the float32
``flash_attention_launch`` of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(a source that also exports ``flash_attention_tile_check``, the 3xTF32
design, takes the wrapper's scratch for its split K/V after the output;
the earlier CUDA-core version of that file takes none).  All sources of a run must be of one
dtype: e.g. that file and an edited copy of it, or the same file from
another checkout (``git show <commit>:<path> > build/pair/old.cu``).  The
script builds every source with nvcc (all at once, ``-Xptxas -v``) and
prints, for each kernel in it, the highest register the SASS names, its
spill instructions and its counts of ``HGMMA``, ``WARPGROUP.ARRIVE`` and
``WARPGROUP.DEPBAR`` (one of each per ``HGMMA`` means ptxas serialised the
products); for a 3xTF32 source, its one-tile check against float64 at each
head width.  Then it holds every version against the plain version
(``kernels/ref.flash_attention_ref``) under ``chip_smoke.py``'s tolerance
for the dtype at ragged and full-size shapes, and times the full-size ones
with CUDA events in alternation (A B ... B A, twice), beside
``scaled_dot_product_attention``.  It exits non-zero if a build fails or a
version leaves the tolerance.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (FLASH_TOL, TILE_CHECK_MAX_REL,  # noqa: E402
                        card_name_and_power, tile_check)
from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402

# (B, Sq, Skv, KV, G, dh, causal): ragged shapes first, then the timed ones
CASES = [(1, 128, 128, 1, 1, 64, True), (2, 1000, 1000, 1, 4, 64, True),
         (2, 1000, 777, 1, 4, 64, False), (1, 300, 300, 2, 2, 32, True),
         (1, 1100, 1300, 2, 3, 32, False), (2, 333, 333, 1, 3, 128, True),
         (1, 900, 700, 2, 2, 128, False)]
TIMED = {"bfloat16": [(1, 2048, 2048, 8, 2, 128, True),
                      (1, 2048, 2048, 8, 2, 128, False),
                      (4, 4096, 4096, 3, 3, 64, True),
                      (1, 32768, 32768, 3, 3, 64, True)],
         "float32": [(4, 4096, 4096, 3, 3, 64, True),
                     (1, 2048, 2048, 8, 2, 128, True)]}


def build(sources, out_dir: Path):
    """One library per source, built in parallel; prints the SASS summary.
    Returns (dtype, [launch function, ...]) with each function taking
    (q, k, v, out, b, sq, skv, kv, g, dh, causal, scale, stream)."""
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / f"v{i}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, src in enumerate(sources)]
    fns, dtypes = [], set()
    for i, (src, proc) in enumerate(zip(sources, procs)):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{log}")
        lib = out_dir / f"v{i}.so"
        sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"),
                               "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        print(f"v{i} = {src}")
        for kern in sass.split("Function : ")[1:]:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", kern)]
            dh = re.search(r"ILi(\d+)E", kern.split()[0])
            print(f"  dh {dh.group(1) if dh else '?'}: max register "
                  f"R{max(regs, default=-1)}, STL {kern.count('STL')}, LDL "
                  f"{kern.count('LDL')}, HGMMA {kern.count('HGMMA')}, "
                  f"WARPGROUP.ARRIVE {kern.count('WARPGROUP.ARRIVE')}, "
                  f"WARPGROUP.DEPBAR {kern.count('WARPGROUP.DEPBAR')}")
        cdll = ctypes.CDLL(str(lib))
        # sources since the query offset take it after `causal` (passed 0)
        offset = "int q_offset" in Path(src).read_text()
        if hasattr(cdll, "flash_attention_sm90_launch"):
            dtypes.add("bfloat16")
            fns.append(plain_launcher(cdll.flash_attention_sm90_launch,
                                      offset))
        elif hasattr(cdll, "flash_attention_tile_check"):
            dtypes.add("float32")
            for dh in cuda_flash.HEAD_DIMS:
                errs = tile_check(cdll, dh)
                print(f"  one-tile 3xTF32 check dh {dh}: S {errs[0]:.3g}, "
                      f"O {errs[1]:.3g} of the float64 product's largest "
                      f"value (limit {TILE_CHECK_MAX_REL:g})")
                if max(errs) > TILE_CHECK_MAX_REL:
                    sys.exit(f"v{i}: the one-tile check failed at dh {dh}")
            fns.append(scratch_launcher(cdll.flash_attention_launch, offset))
        else:
            dtypes.add("float32")
            fns.append(plain_launcher(cdll.flash_attention_launch, offset))
    if len(dtypes) != 1:
        sys.exit("the sources mix bfloat16 and float32 kernels")
    return dtypes.pop(), fns


def _entry(fn, n_ptr: int, offset: bool):
    """``fn`` with its argument types; with ``offset`` it takes a query
    offset after ``causal``, and the returned function passes 0 there."""
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (7 + offset)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if not offset:
        return fn

    def call(*args):
        return fn(*args[:-2], 0, *args[-2:])
    return call


def plain_launcher(fn, offset: bool):
    return _entry(fn, 4, offset)


def scratch_launcher(fn, offset: bool):
    """The 3xTF32 entry point, its scratch allocated per call as the
    wrapper does."""
    fn = _entry(fn, 5, offset)

    def launch(q, k, v, out, b, sq, skv, kv, g, dh, *rest):
        scratch = torch.empty(cuda_flash.f32_scratch_shape(b, skv, kv, dh),
                              device="cuda")
        return fn(q, k, v, out, scratch.data_ptr(), b, sq, skv, kv, g, dh,
                  *rest)
    return launch


def run(fn, q, k, v, causal):
    b, sq, kv, g, dh = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             k.shape[1], kv, g, dh, int(causal), dh ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def time_ms(fn, n: int = 20) -> float:
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main() -> None:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        sys.exit(__doc__)
    print(card_name_and_power())
    with tempfile.TemporaryDirectory() as tmp:
        dtype, fns = build(sys.argv[1:], Path(tmp))
        tol, timed = FLASH_TOL[dtype], TIMED[dtype]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        ok = True
        for b, sq, skv, kv, g, dh, causal in CASES + timed:
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(
                getattr(torch, dtype)) for s in (
                    (b, sq, kv, g, dh), (b, skv, kv, dh), (b, skv, kv, dh)))
            want = ref.flash_attention_ref(q, k, v, causal).float()
            line = f"{(b, sq, skv, kv, g, dh, causal)}:"
            for i, fn in enumerate(fns):
                got = run(fn, q, k, v, causal).float()
                bad = int((~torch.isclose(got, want, **tol)).sum())
                ok &= bad == 0
                line += (f" v{i} max err {(got - want).abs().max().item():.3g}"
                         f", {bad} outside")
            if (b, sq, skv, kv, g, dh, causal) in timed:
                order = list(range(len(fns)))
                ms = {i: [] for i in order}
                for i in (order + order[::-1]) * 2:
                    ms[i].append(time_ms(lambda: run(fns[i], q, k, v, causal)))
                qs = q.permute(0, 2, 3, 1, 4).reshape(b, kv * g, sq, dh)
                ks, vs = (x.permute(0, 2, 1, 3) for x in (k, v))
                qs, ks, vs = (x.contiguous() for x in (qs, ks, vs))
                sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal, enable_gqa=True))
                line += " | " + ", ".join(
                    f"v{i} {min(t):.4f}-{max(t):.4f} ms" for i, t in ms.items())
                line += f", SDPA {sdpa:.4f} ms"
            print(line, flush=True)
    print(f"all versions within the {dtype} tolerance" if ok
          else f"FAILED: a version left the {dtype} tolerance")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
