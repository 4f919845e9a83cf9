"""Where the PyTorch operations of one async serving tick come from.

    PYTHONPATH=src python3 benchmarks/torch_async_ops.py \\
        [--device cpu|cuda] [--ticks 50] [--clients 10000] \\
        [--policy elementwise_ucb]

runs ``repro_torch.sim.async_engine.serve`` at paper-baseline with the
default ``AsyncConfig`` (``launch/serve_fl.py``'s) under torch.profiler,
each of the tick's phase helpers (and the bandit functions they call)
inside a profiler range, and prints the top-level ATen operations per tick charged
to the innermost range around them.  Each such operation is at least one
dispatch on the host and, on the card, typically one kernel launch, so the
table says which part of the tick a CUDA graph or a fused kernel would
save.  The counts are properties of the code, the same on any device; the
script times nothing.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import bandit  # noqa: E402
from repro_torch.sim import async_engine, engine  # noqa: E402

# (module, function) pairs charged separately, innermost range wins
RANGES = [(async_engine, n) for n in (
    "draw_tick", "poll_inputs", "dispatch_plan", "admit", "advance_clock",
    "completion_plan", "gather_aggregated", "churn")] + [
    (engine, "sample_times")] + [(bandit, n) for n in (
        "state_obs", "policy_scores", "greedy_slots", "schedule_completions",
        "first_true", "observe", "censor_slots")]


def _ranged(fn, name):
    @functools.wraps(fn)
    def inner(*args, **kw):
        with record_function("tick:" + name):
            return fn(*args, **kw)
    return inner


def count_ops(device: str, ticks: int, clients: int, policy: str) -> dict:
    saved = [(mod, name, getattr(mod, name)) for mod, name in RANGES]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, _ranged(fn, name))
        kw = dict(n_ticks=ticks, n_clients=clients, seed=0, device=device)
        async_engine.serve("paper-baseline", policy, **kw)      # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            async_engine.serve("paper-baseline", policy, **kw)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    counts = collections.Counter()
    for e in prof.events():
        parent = e.cpu_parent
        if not e.name.startswith("aten::") or (
                parent is not None and parent.name.startswith("aten::")):
            continue
        label = "outside the phase helpers"
        while parent is not None:
            if parent.name.startswith("tick:"):
                label = parent.name[len("tick:"):]
                break
            parent = parent.cpu_parent
        counts[label] += 1
    return {k: v / ticks for k, v in counts.most_common()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--clients", type=int, default=10_000)
    ap.add_argument("--policy", default="elementwise_ucb")
    args = ap.parse_args(argv)
    per_tick = count_ops(args.device, args.ticks, args.clients, args.policy)
    print(f"top-level ATen operations per tick ({args.policy}, "
          f"K={args.clients}, {args.ticks} ticks on {args.device}): "
          f"{sum(per_tick.values()):.1f}")
    for name, n in per_tick.items():
        print(f"  {name:28s} {n:7.1f}")
    print(json.dumps(per_tick))


if __name__ == "__main__":
    main()
