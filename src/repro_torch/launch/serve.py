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
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    api = build(args.arch, reduced=args.reduced, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = api.init(gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[{args.arch}] {api.cfg.n_layers} layers, {n_params} parameters "
          f"({n_params * api.cfg.param_dtype.itemsize / 1e9:.1f} GB)",
          flush=True)
    batch = make_batch(api, np.random.default_rng(args.seed), args.batch,
                       args.prompt_len, dev)
    # the cache holds the whole prompt (a vlm's patches too) and the steps
    seq = batch["tokens"].shape[1] + (api.cfg.n_patches
                                      if api.cfg.family == "vlm" else 0)
    max_len = seq + args.decode_steps

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        prefill_logits, cache, pos = api.prefill(params, batch,
                                                 max_len=max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        print(f"[{args.arch}] prefill: {args.batch}x{args.prompt_len} tokens "
              f"in {t_prefill * 1e3:.1f} ms on {name}", flush=True)

        tok = prefill_logits[:, -1].argmax(-1).to(torch.int32)
        seqs = [tok]
        logits = prefill_logits
        t0 = time.perf_counter()
        for step in range(args.decode_steps):
            logits, cache = api.decode_step(params, cache, tok, pos + step)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            seqs.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
    rate = args.decode_steps * args.batch / max(dt, 1e-9)
    print(f"[{args.arch}] decode: {args.decode_steps} steps x {args.batch} "
          f"seqs in {dt * 1e3:.1f} ms ({rate:.1f} tok/s) on {name}")
    out = torch.stack(seqs, dim=1).cpu().numpy()
    print("sampled token ids (greedy):")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {out[b][:16].tolist()}")
    return {"device": name, "n_params": n_params,
            "n_layers": api.cfg.n_layers, "prefill_ms": t_prefill * 1e3,
            "decode_s": dt, "tok_per_s": rate, "tokens": out,
            "prefill_logits": prefill_logits, "logits": logits}


if __name__ == "__main__":
    main()
