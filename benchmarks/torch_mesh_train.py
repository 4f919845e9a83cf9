"""One AdamW step of an LM at full width over a 1 x R mesh of cards, against
the same step on one card.

    python -m torch.distributed.run --nproc-per-node 4 \
        benchmarks/torch_mesh_train.py --arch qwen3-1.7b --out chiprun_out/mesh_train.json

Every rank draws the whole model from one seed on its card and runs the
one-card step on it (``launch/steps.make_train_step`` without ``mp``),
keeping its blocks of the result; then the sharded step
(``make_train_step(..., mp=)``, tensor parallelism over ``model``) on its
blocks (``sharding.param_specs``) from the same weights and batch.  Both in
float32 compute (TF32 off), so the attention runs the float32 kernel
(``flash_attention.cu``), with remat as the config has it.  Checks, on
every rank's blocks:

  * the loss within rtol 1e-5;
  * both AdamW moments within 1e-5 of the leaf's largest entry (after one
    step m and v are 0.1 g and 0.05 g^2: the gradient); every leaf's
    error and relative L2 distance over that limit is listed;
  * the updated parameters within rtol / atol 1e-5 wherever the one-card
    gradient is at least 1e-6 in magnitude, and within 2 lr elsewhere
    (AdamW's first step is lr * g / (|g| + eps), noise-sensitive where
    |g| is within a few eps of 0; tests/test_torch_mesh_train.py says
    more).

Where the two differ, a third reading says by how much float32 itself
moves: the one-card gradient in float64 (the attention through its plain
float64 version), against which both float32 gradients (m / 0.1) are held
leaf by leaf, by relative L2 distance (``vs_float64``).

Then ``--steps`` more sharded steps are timed (CUDA-synchronised wall
time), beside the one-card step's, with each card's peak device memory.
Writes a JSON record to ``--out`` from rank 0 and prints one line a rank.
``--device cpu --reduced`` runs the same on gloo ranks on the CPU (a check
of the script, no timing worth keeping).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models.layers import ModelParallel  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim.sgd import OptimizerConfig  # noqa: E402
from repro_torch.utils.trees import tree_leaves, tree_map  # noqa: E402

LR, TOL = 3e-4, 1e-5


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(step, params, state, batch, device: str):
    _sync(device)
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)
    _sync(device)
    return params, state, loss, time.perf_counter() - t0


def _peak_gib(device: str) -> float:
    return (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))


def _float64_grads(api, whole, batch, cut) -> dict:
    """This rank's blocks of the one-card gradient in float64 compute, the
    attention through its plain version (the kernels take float32 and
    bfloat16 only)."""
    cfg64 = dataclasses.replace(api.cfg, compute_dtype=torch.float64)
    loss = functools.partial(api.loss_fn.func, cfg=cfg64)
    saved = ops._flash_forward
    ops._flash_forward = (lambda q, k, v, causal, q_offset=0:
                          ref.flash_attention_ref(q, k, v, causal,
                                                  q_offset=q_offset))
    try:
        _, grads = value_and_grad(loss, tree_map(torch.Tensor.double,
                                                 whole), batch)
    finally:
        ops._flash_forward = saved
    return cut(grads)


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    dev = args.device
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0 and dev == "cuda":    # one build; the others load it
        _build.build(("flash_attention", "flash_attention_sm90"))
    dist.barrier()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    api = build(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(api.cfg, compute_dtype=torch.float32)
    api = dataclasses.replace(api, cfg=cfg, loss_fn=functools.partial(
        api.loss_fn.func, cfg=cfg))
    opt_cfg = OptimizerConfig(name="adamw", lr=LR, weight_decay=0.1)
    mesh = make_mesh(1, world, device_type=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    whole = api.init(gen)
    pspecs = sharding.param_specs(whole, cfg, mesh)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.seq)),
        dtype=torch.int32, device=dev)} for _ in range(args.steps + 1)]

    cut = lambda t: sharding.shard_params(t, pspecs, mesh)
    g64 = _float64_grads(api, whole, batches[0], cut)
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the one-card step, kept as this rank's blocks
    one_step, opt = make_train_step(api, opt_cfg)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p1, s1, loss1, one_s = _timed(one_step, whole, opt.init(whole),
                                  batches[0], dev)
    one_peak = _peak_gib(dev)
    _, _, _, one_s2 = _timed(one_step, p1, s1, batches[1], dev)
    want = {"params": cut(p1), "m": cut(s1["m"]), "v": cut(s1["v"]),
            "grad_sure": sharding.shard_params(
                sharding.map_with_path(lambda _, m: (m / 0.1).abs() >= 1e-6,
                                       s1["m"]), pspecs, mesh)}
    mine = cut(whole)
    del whole, p1, s1
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the sharded step from the same weights and batch
    mp = ModelParallel.of(mesh, pspecs, global_batch=args.batch)
    mesh_step, _ = make_train_step(api, opt_cfg, mp=mp)
    sharding.reset_collective_counts()
    p2, s2, loss2, first_s = _timed(mesh_step, mine, opt.init(mine),
                                    batches[0], dev)
    coll = {k: dict(v) for k, v in sharding.collective_counts.items()}
    worst = {"loss": abs(float(loss2) - float(loss1)) / abs(float(loss1))}
    leaves = {}
    for key in ("m", "v"):
        got, ref = (sharding.map_with_path(lambda p, x: (p, x), t)
                    for t in (s2[key], want[key]))
        for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(ref)):
            d = (g - w).double()
            leaves[f"{key}:{path}"] = (
                float(d.abs().max()) / max(float(w.abs().max()), 1e-30),
                float(d.norm()) / max(float(w.double().norm()), 1e-300))
        worst[key] = max(v[0] for k, v in leaves.items()
                         if k.startswith(key + ":"))
        worst[key + "_rel_l2"] = max(v[1] for k, v in leaves.items()
                                     if k.startswith(key + ":"))
    worst["leaves_over"] = {k: v for k, v in leaves.items() if v[0] > TOL}
    vs64 = {"one_card": [], "mesh": []}
    for who, m in (("one_card", want["m"]), ("mesh", s2["m"])):
        vs64[who] = max(_rel_l2(x / 0.1, g) for x, g in
                        zip(tree_leaves(m), tree_leaves(g64)))
    sure = far = 0.0
    for g, w, ok in zip(tree_leaves(p2), tree_leaves(want["params"]),
                        tree_leaves(want["grad_sure"])):
        d = (g - w).abs()
        if bool(ok.any()):
            sure = max(sure, float((d[ok] / (TOL + TOL * w[ok].abs())
                                    ).max()))
        far = max(far, float(d.max()))
    worst["params_sure"], worst["params_max_abs"] = sure, far
    ok = (worst["loss"] <= TOL and worst["m"] <= TOL and worst["v"] <= TOL
          and sure <= 1.0 and far <= 2 * LR)
    times = []
    for b in batches[1:]:
        p2, s2, _, dt = _timed(mesh_step, p2, s2, b, dev)
        times.append(dt)
    peak = _peak_gib(dev)
    rec = {"arch": args.arch, "world": world, "batch": args.batch,
           "seq": args.seq, "compute_dtype": "float32", "remat": cfg.remat,
           "ok": ok, "worst": worst, "vs_float64": vs64,
           "loss_one_card": float(loss1),
           "loss_mesh": float(loss2), "one_card_s": [one_s, one_s2],
           "one_card_peak_gib": one_peak, "mesh_first_s": first_s,
           "mesh_s": times, "mesh_peak_gib": peak, "collectives": coll,
           "card": (torch.cuda.get_device_name(local) if dev == "cuda"
                    else "cpu")}
    print(f"rank {rank}: {json.dumps(rec)}", flush=True)
    recs = [None] * world
    dist.all_gather_object(recs, rec)
    if rank == 0 and args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    dist.barrier()
    dist.destroy_process_group()
    if not all(r["ok"] for r in recs):
        raise SystemExit(f"a rank's step differs from the one-card step: "
                         f"{[r['worst'] for r in recs]}")
    return rec


if __name__ == "__main__":
    main()
