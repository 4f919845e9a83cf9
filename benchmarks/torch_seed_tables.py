"""The port's results for two of the JAX package's seeded experiments, from
the same seeds (the port draws the JAX package's Threefry streams,
``sim/engine.KeyStreams``):

  * the table ``examples/eta_sweep.py`` prints at its defaults (6 policies
    x 4 eta x 3 seeds x 200 rounds, and the stable sweep without
    fluctuation): each MAB policy's mean elapsed time against FedCS's;
  * the time-only part of ``benchmarks/bench_fault_tolerance.py``
    (``bench_elapsed``: 10 % crashes, a 2500 s deadline, 4 policies x
    8 seeds x 500 rounds at K = 100): each policy's median total simulated
    time and its crash and deadline-miss rates, the numbers
    ``BENCH_fault_tolerance.json`` keeps under ``"elapsed"``; with
    ``--fast``, at that bench's ``--fast`` sizes (2 seeds x 100 rounds at
    K = 50, 30 % polled).

It writes no file.  Run from the repository root:

  PYTHONPATH=src python benchmarks/torch_seed_tables.py --device cpu

(without ``--device`` on the card).  The last line is one JSON object with
both results and the seconds each took.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.sim import engine
from repro_torch.sim.scenarios import FaultModel, Scenario

ETA_POLICIES = ("fedcs", "extended_fedcs", "naive_ucb", "elementwise_ucb",
                "discounted_ucb", "sliding_ucb")
ETAS = (1.0, 1.5, 1.9, 1.99)
FAULT_POLICIES = ("elementwise_ucb", "naive_ucb", "fedcs", "random")


def eta_table(device) -> tuple[list[str], dict]:
    """examples/eta_sweep.py's table: (printed lines, the rows)."""
    kw = dict(scenario="paper-baseline", policies=ETA_POLICIES, seeds=3,
              n_rounds=200, n_clients=100, device=device)
    res = engine.sweep(etas=ETAS, **kw)
    stable = engine.sweep(etas=(0.0,), fluctuate=False, **kw)
    lines = [f"{'eta':>6} | " + " | ".join(f"{p:>16}"
                                           for p in ETA_POLICIES[1:])]
    rows = {}
    for label, el in [("stable", stable.mean_elapsed()[:, 0])] + [
            (f"{eta:.2f}", res.mean_elapsed()[:, i])
            for i, eta in enumerate(ETAS)]:
        fed = el[0]
        gain = [100 * (fed - el[i]) / fed for i in range(1, len(el))]
        rows[label] = dict(zip(ETA_POLICIES[1:], (float(g) for g in gain)))
        lines.append(f"{label:>6} | " + " | ".join(f"{g:+15.2f}%"
                                                   for g in gain))
    return lines, rows


def fault_medians(device, fast: bool = False) -> dict:
    """bench_fault_tolerance.bench_elapsed's numbers, by policy."""
    scen = Scenario("crash10", fault=FaultModel(crash_prob=0.10))
    res = engine.sweep(scen, policies=FAULT_POLICIES, etas=(1.5,),
                       seeds=2 if fast else 8,
                       n_rounds=100 if fast else 500,
                       n_clients=50 if fast else 100, s_round=5,
                       frac_request=0.3 if fast else 0.1, deadline=2500.0,
                       device=device)
    n_pol = len(FAULT_POLICIES)
    med = np.median(res.round_times.sum(axis=-1).reshape(n_pol, -1), axis=1)
    fc = {k: v.reshape(n_pol, -1).sum(axis=1)
          for k, v in res.fault_counts().items()}
    return {p: {"median_total_s": round(float(med[i]), 1),
                "deadline_miss_rate": round(float(
                    fc["deadline_missed"][i] / fc["dispatched"][i]), 4),
                "crash_rate": round(float(
                    fc["crashed"][i] / fc["dispatched"][i]), 4)}
            for i, p in enumerate(FAULT_POLICIES)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--fast", action="store_true",
                    help="the fault bench's --fast sizes")
    args = ap.parse_args()
    device = engine.resolve_device(args.device)
    t0 = time.perf_counter()
    lines, rows = eta_table(device)
    t1 = time.perf_counter()
    medians = fault_medians(device, args.fast)
    t2 = time.perf_counter()
    print("\n".join(lines))
    for p, m in medians.items():
        print(f"fault_tolerance/elapsed_{p}: {m}")
    print(json.dumps({"device": str(device), "eta_table": rows,
                      "fault_elapsed": medians, "eta_table_s": t1 - t0,
                      "fault_elapsed_s": t2 - t1}))


if __name__ == "__main__":
    main()
