"""Paired sweep rates of two checkouts of the PyTorch port on one card.

    python3 benchmarks/torch_paired_sweep.py --parent DIR [--pairs 12]

from the root of a checkout (the "change"); ``DIR`` is another checkout
(the "parent", e.g. unpacked from ``git archive``).  It starts one worker
process per checkout, warms each (kernel build, first sweep), then runs
each cell in alternating pairs (parent first in even pairs, change first
in odd ones) and prints each run's rounds/s, the medians and quartiles,
the pairs the change won, and a verdict: "faster"/"slower" only when the
change wins/loses at least nine tenths of the pairs and the medians differ
by more than the parent's interquartile range, else "unresolved".  The
last line is a JSON object with every run.  Needs a CUDA card.

The cells are ``chip_smoke.py``'s phase 4a (paper-baseline, K=10^4,
8 policies x 8 seeds x 500 rounds, streamed sampling) and phase 5
(metro-congestion, K=10^5, 8 policies x 1 seed x 100 rounds).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CELLS = {
    "4a": dict(scenario="paper-baseline", etas=(1.5,), seeds=8,
               n_rounds=500, n_clients=10_000),
    "5": dict(scenario="metro-congestion", etas=(1.5,), seeds=1,
              n_rounds=100, n_clients=100_000),
}


def worker(tree: str) -> None:
    """Answer one JSON cell name per input line with that cell's rounds/s
    (one JSON line on stdout)."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch

    from repro_torch.sim import engine
    for line in sys.stdin:
        kw = CELLS[json.loads(line)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.sweep(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p, _, _, r = res.round_times.shape
        print(json.dumps(p * r / wall), flush=True)


def verdict(parent: list[float], change: list[float]) -> dict:
    q1, _, q3 = statistics.quantiles(parent, n=4)
    mp, mc = statistics.median(parent), statistics.median(change)
    won = sum(c > p for p, c in zip(parent, change))
    lost = sum(c < p for p, c in zip(parent, change))
    n = len(parent)
    far = abs(mc - mp) > q3 - q1
    word = ("faster" if won >= 0.9 * n and far else
            "slower" if lost >= 0.9 * n and far else "unresolved")
    return dict(parent_median=mp, change_median=mc, parent_iqr=q3 - q1,
                change_pct=100 * (mc / mp - 1), change_won=won,
                change_lost=lost, pairs=n, verdict=word)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    trees = {"parent": str(Path(args.parent).resolve()),
             "change": str(Path(__file__).resolve().parents[1])}
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, "--parent", "-", "--worker", tree],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for side, tree in trees.items()}

    def run(side: str, cell: str) -> float:
        proc = procs[side]
        proc.stdin.write(json.dumps(cell) + "\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"{side} worker died")
        return json.loads(line)

    try:
        for side in procs:                  # build and warm each checkout
            for cell in CELLS:
                run(side, cell)
        runs = {cell: {"parent": [], "change": []} for cell in CELLS}
        for i in range(args.pairs):
            order = ("parent", "change") if i % 2 == 0 else ("change",
                                                             "parent")
            for cell in CELLS:
                for side in order:
                    runs[cell][side].append(run(side, cell))
                print(f"[pair {i}] phase {cell}: parent "
                      f"{runs[cell]['parent'][-1]:.1f}, change "
                      f"{runs[cell]['change'][-1]:.1f} rounds/s "
                      f"({order[0]} first)", flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=60)
    summary = {cell: verdict(r["parent"], r["change"])
               for cell, r in runs.items()}
    for cell, v in summary.items():
        print(f"[paired] phase {cell}: parent median "
              f"{v['parent_median']:.1f} (IQR {v['parent_iqr']:.1f}), "
              f"change median {v['change_median']:.1f} "
              f"({v['change_pct']:+.1f} %), change won {v['change_won']} "
              f"of {v['pairs']} pairs: {v['verdict']}")
    print(json.dumps({"runs": runs, "summary": summary}))


if __name__ == "__main__":
    main()
