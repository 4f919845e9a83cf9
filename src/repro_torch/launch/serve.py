"""Batched inference: prefill + greedy decode for every registry arch —
the port of ``repro.launch.serve``.

  python -m repro_torch.launch.serve --arch smollm-135m --full \\
      --batch 4 --prompt-len 4096 --decode-steps 32
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --full \\
      --batch 4 --prompt-len 4096 --decode-steps 16
  python -m repro_torch.launch.serve --arch seamless-m4t-medium --full \\
      --batch 4 --prompt-len 4096 --decode-steps 16
  python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --full \\
      --layers 8 --batch 4 --prompt-len 4096 --decode-steps 16

runs on the card (the default); ``--device cpu`` runs the plain PyTorch
path on the CPU.  ``--layers`` cuts the depth and keeps every width, for a
full-width model whose float32 weights one card cannot hold whole.
Weights are random, drawn from ``--seed`` (no weights are fetched); the
inputs come from ``numpy.random.default_rng(seed)`` in the JAX package's
order (:func:`make_batch`).  Prefill time and decode tokens/s are read on
the host clock after synchronising the card; the first prefill of a
process also pays one-time start-up (cuBLAS handles, the kernel library's
load).

``--mesh DxM`` serves over a (data, model) device mesh of D·M ranks, one
card each:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 1x4 \
      --arch llava-next-34b --full --layers 8 --prompt-len 4096

(on the CPU: ``--device cpu``, gloo ranks).  Every rank draws the model
from ``--seed`` one layer at a time and keeps its blocks of each draw by
``distributed/sharding.param_specs`` (FSDP above 3·10⁹ parameters, as
``launch/steps.build_cell``; ``sharding.block_keeper``), so a rank holds
its share of the weights and one layer whole, the same weights as one
process draws; it takes its batch rows by ``batch_specs`` and runs the
model-parallel route (models/layers.py); the logits it returns are its
rows, whole over the vocab.  The cache's max_len is rounded up to a
multiple of M.  Without a process group (torchrun's environment) it
starts one: NCCL on the card, gloo on the CPU.  With no ``--mesh`` it is
the one-process path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.models.registry import build
from repro_torch.sim.engine import resolve_device
from repro_torch.utils.trees import tree_leaves


def _bf16_normals(rng: np.random.Generator, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape)).to(
        device=device, dtype=torch.bfloat16)


def make_batch(api, rng: np.random.Generator, batch: int, prompt_len: int,
               device=None) -> dict:
    """The inputs of one prefill, drawn from ``rng`` in the JAX package's
    order: uniform token ids ``tokens`` [batch, prompt_len] int32; a vlm's
    ``tokens`` [batch, max(prompt_len - n_patches, 1)] first, then
    ``patch_embeds`` [batch, n_patches, patch_embed_dim] of standard
    normals in bfloat16; an enc-dec's ``frames`` [batch, prompt_len,
    d_model] of standard normals in bfloat16 first, then ``tokens``
    [batch, prompt_len]."""
    cfg = api.cfg

    def tokens(n):
        return torch.tensor(rng.integers(0, cfg.vocab, (batch, n)),
                            dtype=torch.int32, device=device)
    if cfg.family == "vlm":
        toks = tokens(max(prompt_len - cfg.n_patches, 1))
        return {"tokens": toks, "patch_embeds": _bf16_normals(
            rng, (batch, cfg.n_patches, cfg.patch_embed_dim), device)}
    if cfg.family == "encdec":
        frames = _bf16_normals(rng, (batch, prompt_len, cfg.d_model), device)
        return {"frames": frames, "tokens": tokens(prompt_len)}
    return {"tokens": tokens(prompt_len)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run one prefill and ``--decode-steps`` greedy steps; print and return
    ``{"device", "n_params", "n_layers", "prefill_ms", "decode_s",
    "tok_per_s", "tokens" [B, steps + 1] int, "prefill_logits" [B, 1, V],
    "logits" [B, 1, V]}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (decoder layers "
                         "for enc-dec); every width is kept")
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default")
    ap.add_argument("--mesh", default=None,
                    help="serve over a DxM (data x model) device mesh of "
                         "the process group's ranks")
    args = ap.parse_args(argv)

    mesh = mp = None
    if args.mesh is not None:
        dev, mesh = _mesh_device(args.mesh, args.device)
    else:
        dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say = print if mesh is None or dist.get_rank() == 0 else _quiet
    api = build(args.arch, reduced=args.reduced, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_params = api.param_counts()[0]
    pspecs = None
    if mesh is None:
        params = api.init(gen)
    else:                        # FSDP above 3e9 parameters, as build_cell
        pspecs = sharding.param_specs(api.param_shapes(), api.cfg, mesh,
                                      fsdp=n_params > 3e9)
        params = api.init(gen, keep=sharding.block_keeper(
            pspecs, sharding.axis_sizes(mesh), sharding.mesh_coords(mesh)))
    say(f"[{args.arch}] {api.cfg.n_layers} layers, {n_params} parameters "
        f"({n_params * api.cfg.param_dtype.itemsize / 1e9:.1f} GB)",
        flush=True)
    batch = make_batch(api, np.random.default_rng(args.seed), args.batch,
                       args.prompt_len, dev)
    # the cache holds the whole prompt (a vlm's patches too) and the steps
    seq = batch["tokens"].shape[1] + (api.cfg.n_patches
                                      if api.cfg.family == "vlm" else 0)
    max_len = seq + args.decode_steps
    if mesh is not None:
        batch, mp = _shard_batch(batch, pspecs, mesh)
        m = mp.m
        max_len = -(-max_len // m) * m
        say(f"[{args.arch}] mesh {args.mesh} over {dist.get_world_size()} "
            f"ranks; rank {dist.get_rank()} holds "
            f"{sum(t.numel() for t in tree_leaves(params))} parameters "
            f"and {batch['tokens'].shape[0]} of {args.batch} sequences",
            flush=True)

    counts = {}
    with torch.inference_mode():
        _sync(dev)
        sharding.reset_collective_counts()
        t0 = time.perf_counter()
        prefill_logits, cache, pos = api.prefill(params, batch,
                                                 max_len=max_len, mp=mp)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        counts["prefill"] = _counts()
        say(f"[{args.arch}] prefill: {args.batch}x{args.prompt_len} tokens "
            f"in {t_prefill * 1e3:.1f} ms on {name}", flush=True)

        tok = prefill_logits[:, -1].argmax(-1).to(torch.int32)
        seqs = [tok]
        logits = prefill_logits
        sharding.reset_collective_counts()
        t0 = time.perf_counter()
        for step in range(args.decode_steps):
            logits, cache = api.decode_step(params, cache, tok, pos + step,
                                            mp=mp)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            seqs.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
        counts["decode"] = _counts()
    n_seq = batch["tokens"].shape[0]
    rate = args.decode_steps * n_seq / max(dt, 1e-9)
    say(f"[{args.arch}] decode: {args.decode_steps} steps x {n_seq} "
        f"seqs in {dt * 1e3:.1f} ms ({rate:.1f} tok/s) on {name}")
    if mesh is not None:
        say(f"[{args.arch}] collectives (calls, bytes) prefill "
            f"{counts['prefill']}, decode {counts['decode']}")
    out = torch.stack(seqs, dim=1).cpu().numpy()
    say("sampled token ids (greedy):")
    for b in range(min(n_seq, 2)):
        say(f"  seq{b}: {out[b][:16].tolist()}")
    return {"device": name, "n_params": n_params,
            "n_layers": api.cfg.n_layers, "prefill_ms": t_prefill * 1e3,
            "decode_s": dt, "tok_per_s": rate, "tokens": out,
            "prefill_logits": prefill_logits, "logits": logits,
            "collectives": counts if mesh is not None else None}


def _quiet(*_, **__) -> None:
    pass


def _counts() -> dict:
    return {k: (v["calls"], v["bytes"])
            for k, v in sharding.collective_counts.items()}


def _mesh_device(text: str, device):
    """(this rank's device, the mesh ``text``) over the default process
    group, started from torchrun's environment when there is none: NCCL
    on the card (cuda:LOCAL_RANK), gloo on the CPU."""
    import os

    from repro_torch.launch.mesh import make_mesh, parse_mesh
    sizes = parse_mesh(text)
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device if device is not None else
                             f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    mesh = make_mesh(sizes["data"], sizes["model"], pod=sizes.get("pod"),
                     device_type=dev.type)
    return dev, mesh


def _shard_batch(batch, pspecs, mesh):
    """This rank's rows of ``batch`` and its ``ModelParallel`` for
    parameters of the spec tree ``pspecs``."""
    from repro_torch.models.layers import ModelParallel
    bspecs = sharding.batch_specs(batch, mesh)
    mp = ModelParallel.of(mesh, pspecs,
                          global_batch=batch["tokens"].shape[0])
    return sharding.shard_params(batch, bspecs, mesh), mp


if __name__ == "__main__":
    main()
