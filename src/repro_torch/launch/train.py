"""The FL training loop — the port of ``repro.launch.train``, the
end-to-end entry point of training.

Runs the paper's protocol with any selection policy against the resource
simulator, training the selected model for real:

  python -m repro_torch.launch.train --arch cifar-cnn \\
      --policy elementwise_ucb --rounds 50 --eta 1.5 --ckpt-dir runs/fl \\
      [--resume]

on the card (the default; ``--device cpu`` runs the plain PyTorch path on
the CPU).  ``--arch none`` is the time-only server (all numpy, bitwise the
JAX package's, so its lines are the same on any device); ``--arch
cifar-cnn`` trains the paper's CNN (``--fast``: 5000 images, one epoch);
any registry arch fine-tunes its reduced config on synthetic token shards.

Fault tolerance: checkpoints (model, bandit statistics, the server's and
the trainer's ``numpy`` generators, a discounted policy's statistics and
the elapsed clock) every ``--ckpt-every`` rounds; ``--resume`` restarts from
the newest valid checkpoint and then runs exactly as an uninterrupted run
would (the JAX package's ``train`` restores no generator, so its resumed
rounds draw differently); ``--failure-prob`` injects mid-round client
failures; elasticity via ``--swap-clients`` (every N rounds a random
client's arm is reset: the paper's cold-start rule).  The lines printed
are those of the JAX package's ``train``.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                         bandit_state_tree,
                                         restore_bandit_state, restore_rng,
                                         rng_state_tree)
from repro_torch.core.host_bandit import make_policy
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.sim.engine import resolve_device
from repro_torch.sim.network import make_network_env
from repro_torch.sim.resources import PAPER_MODEL_BITS, ResourceModel
from repro_torch.utils.trees import tree_map


def build_trainer(arch: str, env, seed: int, fast: bool, device=None):
    if arch == "none":
        return None
    if arch == "cifar-cnn":
        from repro_torch.fl.cnn_trainer import CnnFlTrainer
        if fast:
            return CnnFlTrainer(env.n_clients, np.minimum(env.n_samples, 200),
                                seed=seed, n_train=5000, n_test=1000,
                                epochs=1, device=device)
        return CnnFlTrainer(env.n_clients, env.n_samples, seed=seed,
                            device=device)
    # LM archs: FL fine-tuning of the reduced config on synthetic shards
    from repro_torch.fl.lm_trainer import LmFlTrainer
    return LmFlTrainer(arch, env.n_clients, env.n_samples, seed=seed,
                       device=device)


def _policy_state(policy) -> dict | None:
    """A discounted policy's own statistics (None for the others)."""
    d = getattr(policy, "disc", None)
    if d is None:
        return None
    return {"n": d.n, "sum_ud": d.sum_ud, "sum_ul": d.sum_ul,
            "total": np.asarray(d.total)}


def _save(mgr, step: int, srv, trainer) -> None:
    state = {"bandit": bandit_state_tree(srv.stats),
             "server": {"elapsed": np.asarray(srv.elapsed),
                        "failed_rounds": np.asarray(srv.failed_rounds),
                        "rounds_done": np.asarray(
                            trainer.rounds_done if trainer else 0)},
             "rng": {"server": rng_state_tree(srv.rng)},
             "policy": _policy_state(srv.policy)}
    if trainer is not None:
        state["params"] = trainer.params
        if hasattr(trainer, "rng"):
            state["rng"]["trainer"] = rng_state_tree(trainer.rng)
    mgr.save(step, state)


def _restore(mgr, srv, trainer) -> int:
    step, state = mgr.restore()
    restore_bandit_state(srv.stats, state["bandit"])
    srv.elapsed = float(state["server"]["elapsed"])
    srv.failed_rounds = int(state["server"].get("failed_rounds", 0))
    if "rng" in state:
        restore_rng(srv.rng, state["rng"]["server"])
    if state.get("policy") is not None:
        d = srv.policy.disc
        for name in ("n", "sum_ud", "sum_ul"):
            getattr(d, name)[...] = state["policy"][name]
        d.total = float(state["policy"]["total"])
    if trainer is not None and "params" in state:
        # onto the trainer's own tree: the checkpoint sorts dict keys
        trainer.params = tree_map(
            lambda like, x: torch.as_tensor(x, dtype=like.dtype,
                                            device=like.device),
            trainer.params, state["params"])
        trainer.rounds_done = int(state["server"]["rounds_done"])
        if "trainer" in state.get("rng", {}):
            restore_rng(trainer.rng, state["rng"]["trainer"])
    return step


def main(argv=None) -> dict:
    """Run the rounds; print the JAX package's lines and return ``{"server",
    "trainer", "start", "wall_s", "round_s" (wall seconds of each round
    run here, checkpoint saves excluded)}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cifar-cnn",
                    help="cifar-cnn | none (time-only) | any registry arch "
                         "(reduced config, FL fine-tuning)")
    ap.add_argument("--policy", default="elementwise_ucb")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--eta", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--failure-prob", type=float, default=0.0)
    ap.add_argument("--swap-clients", type=int, default=0,
                    help="every N rounds, replace a random client with a "
                         "fresh one (elastic membership)")
    ap.add_argument("--deadline", type=float, default=math.inf)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    env = make_network_env(args.clients, rng)
    res = ResourceModel(env, eta=args.eta, model_bits=PAPER_MODEL_BITS)
    policy = make_policy(args.policy, args.clients, 5)
    trainer = build_trainer(args.arch, env, args.seed, args.fast, dev)
    srv = FederatedServer(
        FLConfig(n_clients=args.clients, n_rounds=args.rounds,
                 deadline_s=args.deadline, seed=args.seed),
        policy, res, trainer)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        start = _restore(mgr, srv, trainer)
        print(f"resumed from round {start} (elapsed {srv.elapsed:.0f}s)")

    t0 = time.time()
    round_s = []
    for r in range(start, args.rounds):
        tr = time.perf_counter()
        mask = None
        if args.failure_prob > 0:
            mask = srv.rng.uniform(size=args.clients) < args.failure_prob
        rec = srv.run_round(r, failure_mask=mask)
        if args.swap_clients and (r + 1) % args.swap_clients == 0:
            k = int(srv.rng.integers(0, args.clients))
            srv.stats.forget(k)          # fresh arm: cold-start exploration
            print(f"  [elastic] client {k} replaced (arm reset)")
        msg = (f"round {r:4d}  sel={rec.selected}  "
               f"round_time={rec.round_time:7.1f}s  "
               f"elapsed={rec.elapsed / 3600:6.2f}h")
        if trainer is not None and hasattr(trainer, "accuracy") and \
                (r + 1) % max(args.rounds // 10, 1) == 0:
            msg += f"  acc={trainer.accuracy():.3f}"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_s.append(time.perf_counter() - tr)
        print(msg, flush=True)
        if mgr and (r + 1) % args.ckpt_every == 0:
            _save(mgr, r + 1, srv, trainer)
    wall = time.time() - t0
    print(f"done: {args.rounds - start} rounds in {wall:.0f}s wall, "
          f"{srv.elapsed/3600:.2f}h simulated")
    return {"server": srv, "trainer": trainer, "start": start,
            "wall_s": wall, "round_s": round_s}


if __name__ == "__main__":
    main()
