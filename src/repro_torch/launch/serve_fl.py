"""Long-running async FL serving (resumable million-tick runs) —
the PyTorch port of ``repro.launch.serve_fl``.

Runs the bounded-staleness serving engine (``sim/async_engine.py``) as a
sequence of segments and snapshots the whole serving state — bandit
statistics, the in-flight buffer, counters and the tick cursor — through
``checkpoint/ckpt.py`` after each.  Every draw is a pure function of (seed,
absolute tick), so a run killed at a segment boundary resumes bitwise from
its newest checkpoint.

  python -m repro_torch.launch.serve_fl \\
      --scenario diurnal-drift --policy elementwise_ucb \\
      --ticks 1000000 --segment 5000 --ckpt-dir runs/serve

runs on the card (the default); ``--device cpu`` runs the plain PyTorch
path.  Re-running the same command after a crash picks up from the newest
valid checkpoint; ``--fresh`` ignores existing ones.  The run's identity
(``_run_meta``) is the JAX package's, and the device is not part of it, so
a checkpoint directory of the JAX package's ``serve_fl`` resumes here.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.sim import async_engine
from repro_torch.sim import engine as sim
from repro_torch.sim.scenarios import Scenario, get_scenario

_STATE_KEY = "async_serve"


def _run_meta(scenario: str, policy: str, cfg: async_engine.AsyncConfig,
              *, ticks: int, seed: int, n_clients: int, env_seed: int,
              eta: float, fluctuate: bool) -> dict:
    """The run identity a checkpoint must match to be resumed into this
    invocation: same seed, horizon and config mean the same draws."""
    return {"scenario": scenario, "policy": policy,
            "cfg": dataclasses.asdict(cfg), "ticks": ticks, "seed": seed,
            "n_clients": n_clients, "env_seed": env_seed, "eta": eta,
            "fluctuate": fluctuate}


def _as_python(tree):
    """A restored tree with its 0-d numpy leaves as Python scalars."""
    if isinstance(tree, dict):
        return {k: _as_python(v) for k, v in tree.items()}
    return tree.item() if isinstance(tree, np.ndarray) else tree


def _template(cfg: async_engine.AsyncConfig, meta: dict, env) -> dict:
    """The checkpoint's trees as this run writes them: how a checkpoint of
    the JAX package (whose structure is a pickle) is rebuilt."""
    state = async_engine.AsyncState.create(env, cfg)
    return {_STATE_KEY: async_engine.snapshot_tree(state), "meta": meta}


def run_serving(scenario: str | Scenario = "paper-baseline",
                policy: str = "elementwise_ucb", *,
                ticks: int = 10_000, segment: int = 1_000,
                ckpt_dir: str | None = None, keep_last: int = 3,
                seed: int = 0, n_clients: int = 100, env_seed: int = 0,
                cfg: async_engine.AsyncConfig | None = None,
                eta: float = 1.5, fluctuate: bool = True,
                resume: bool = True, max_segments: int | None = None,
                log=print, device=None) -> dict:
    """Serve ``ticks`` ticks in segments with a snapshot after each; the
    arguments are those of the JAX package's ``run_serving``, plus
    ``device`` (None = the card; ``"cpu"`` runs the plain PyTorch path).

    Returns a summary dict (final counters, elapsed simulated time, wall
    time, ticks/s) and the final :class:`~repro_torch.sim.async_engine.
    AsyncState`.  With ``ckpt_dir`` set, each segment boundary writes an
    atomic checkpoint, and a checkpoint of the same run identity found at
    start is resumed from (``resume=False`` starts fresh); a checkpoint of
    another run raises ``ValueError``, and a directory whose checkpoints
    are all corrupt starts fresh.  ``max_segments`` stops after that many
    segments — a controlled "crash"; re-invoking continues.
    """
    device = sim.resolve_device(device)
    scen_name = scenario if isinstance(scenario, str) else scenario.name
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    cfg = cfg or async_engine.AsyncConfig()
    meta = _run_meta(scen_name, policy, cfg, ticks=ticks, seed=seed,
                     n_clients=n_clients, env_seed=env_seed, eta=eta,
                     fluctuate=fluctuate)
    env = sim.EnvArrays.from_scenario(
        scen, scen.build_env(n_clients, np.random.default_rng(env_seed)),
        device)

    mgr = CheckpointManager(ckpt_dir, keep_last=keep_last) if ckpt_dir \
        else None
    state = None
    t0 = 0
    if mgr is not None and resume and mgr.latest_step() is not None:
        # restore() skips checkpoints whose checksums fail and falls back to
        # the newest valid one: a crash mid-checkpoint costs one segment
        try:
            step, snap = mgr.restore(like=_template(cfg, meta, env))
        except FileNotFoundError:
            log(f"[serve_fl] no valid checkpoint in {ckpt_dir} "
                f"(all corrupt?) — starting fresh")
            step, snap = None, None
        if snap is not None:
            saved_meta = _as_python(snap.get("meta", {}))
            if saved_meta != meta:
                raise ValueError(
                    f"checkpoint at step {step} in {ckpt_dir} belongs to a "
                    f"different run (saved {saved_meta}, requested {meta}); "
                    "pass --fresh / resume=False or a new --ckpt-dir")
            state = async_engine.state_from_snapshot(snap[_STATE_KEY],
                                                     device)
            t0 = int(state.tick)
            log(f"[serve_fl] resumed from checkpoint step {step} "
                f"(tick {t0})")

    wall0 = time.perf_counter()
    done = t0
    segments = 0
    while done < ticks and (max_segments is None
                            or segments < max_segments):
        n = min(segment, ticks - done)
        res = async_engine.serve(
            scen, policy, n_ticks=n, total_ticks=ticks, t0=done, seed=seed,
            cfg=cfg, n_clients=n_clients, env=env, state=state, eta=eta,
            fluctuate=fluctuate, device=device)
        state = res.state
        done += n
        segments += 1
        if mgr is not None:
            mgr.save(done, {_STATE_KEY: async_engine.snapshot_tree(state),
                            "meta": meta})
        log(f"[serve_fl] tick {done}/{ticks}  sim_t={float(state.now):.1f}  "
            f"admitted={int(state.n_admitted)} "
            f"aggregated={int(state.n_aggregated)} "
            f"dropped={int(state.n_dropped)} "
            f"failed={int(state.n_failed)}")
    if state is None:
        state = async_engine.AsyncState.create(env, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - wall0

    return {
        "scenario": scen_name, "policy": policy, "ticks": done,
        "sim_time": float(state.now),
        "admitted": int(state.n_admitted),
        "aggregated": int(state.n_aggregated),
        "dropped": int(state.n_dropped),
        "failed": int(state.n_failed),
        "corrupt": int(state.n_corrupt),
        "buffered": int((state.buf_client >= 0).sum()),
        "wall_s": wall,
        "ticks_per_s": (done - t0) / wall if wall > 0 else float("inf"),
        "state": state,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="resumable async FL serving simulation")
    ap.add_argument("--scenario", default="paper-baseline")
    ap.add_argument("--policy", default="elementwise_ucb")
    ap.add_argument("--ticks", type=int, default=10_000)
    ap.add_argument("--segment", type=int, default=1_000)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-clients", type=int, default=100)
    ap.add_argument("--env-seed", type=int, default=0)
    ap.add_argument("--eta", type=float, default=1.5)
    ap.add_argument("--n-slots", type=int, default=32)
    ap.add_argument("--buffer-size", type=int, default=5)
    ap.add_argument("--max-staleness", type=int, default=50)
    ap.add_argument("--s-dispatch", type=int, default=5)
    ap.add_argument("--n-req", type=int, default=10)
    ap.add_argument("--tick-dt", type=float, default=None,
                    help="fixed tick length (default: schedule-paced)")
    ap.add_argument("--arrival", choices=["poisson", "full"],
                    default="poisson")
    ap.add_argument("--arrival-rate", type=float, default=5.0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-dispatch deadline in seconds; switches on the "
                         "failure-aware layer (default: off)")
    ap.add_argument("--backoff-base", type=float, default=2.0)
    ap.add_argument("--backoff-max", type=float, default=64.0)
    ap.add_argument("--max-segments", type=int, default=None,
                    help="stop after N segments (restart smoke tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = async_engine.AsyncConfig(
        n_slots=args.n_slots, buffer_size=args.buffer_size,
        max_staleness=args.max_staleness, s_dispatch=args.s_dispatch,
        n_req=args.n_req, tick_dt=args.tick_dt, arrival=args.arrival,
        arrival_rate=args.arrival_rate, deadline=args.deadline,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max)
    out = run_serving(
        args.scenario, args.policy, ticks=args.ticks, segment=args.segment,
        ckpt_dir=args.ckpt_dir, seed=args.seed, n_clients=args.n_clients,
        env_seed=args.env_seed, cfg=cfg, eta=args.eta,
        resume=not args.fresh, max_segments=args.max_segments,
        device=args.device)
    print(f"[serve_fl] done: {out['ticks']} ticks, "
          f"sim_time={out['sim_time']:.1f}, "
          f"aggregated={out['aggregated']}, dropped={out['dropped']}, "
          f"failed={out['failed']}, {out['ticks_per_s']:.0f} ticks/s")


if __name__ == "__main__":
    main()
