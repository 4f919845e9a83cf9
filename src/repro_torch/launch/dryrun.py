"""The dry run over a device mesh: every (arch x input shape x mesh) cell,
one rank's sharded program on ``meta`` tensors — the port's counterpart of
``repro.launch.dryrun`` and ``repro.launch.hlo_analysis``.

    python -m repro_torch.launch.dryrun                  # every cell, 16x16 and 2x16x16
    python -m repro_torch.launch.dryrun --mesh 1x4 --mesh 1x8 --arch llava-next-34b
    python -m repro_torch.launch.dryrun --reduced --mesh 2x4 --no-production
    python -m repro_torch.launch.dryrun --fl-round smollm-135m --compress int8

The JAX package lowers and compiles each cell on 256 and 512 fake XLA
devices.  Here rank 0 of a fake process group of the mesh's world size
(``torch.testing``'s ``FakeStore``, backend ``"fake"``: collectives return
at once and move nothing) builds the mesh, cuts the parameters, the batch
and the cache to its blocks by the specs of ``launch/steps.build_cell``
and runs the cell's step on them: a prefill, a decode step at the last
position, or a train cell's AdamW step (``launch/steps.make_train_step``
with ``mp``: the loss, its backward through the collectives' autograd
Functions, the sum of each leaf's gradient over the batch axes and the
update of this rank's blocks and moments).  On ``meta`` tensors nothing
is computed and no kernel launches: attention takes its plain blockwise
route, as on the CPU.  For each cell it reports

  * bytes one rank holds, from the specs: parameters, optimizer state
    (AdamW, train cells), cache (decode cells) and inputs, and whether
    they fit in one H100's 80 GB (8e10 bytes; activations not counted);
    ``params_fit`` for the parameters alone; ``init_bytes``, the rank's
    parameters and the largest subtree an ``init`` draws whole before
    ``sharding.block_keeper`` cuts it (one layer, or the embedding), the
    least the draw needs (``serve.py --mesh``);
  * FLOPs of one rank's matmuls, by ``torch.utils.flop_counter
    .FlopCounterMode`` over the step (2 per multiply-add; ``flops_of``
    says which step: ``train``, ``prefill`` or ``decode``), and for a
    train cell also ``forward_flops``, the loss's forward alone;
  * the collectives the rank issued, calls and bytes by kind
    (``distributed/sharding.collective_counts``), a train cell's in both
    passes: with ``remat`` each layer's forward collectives run a second
    time in the backward's recompute;

and writes them to a JSON file after every cell (``--out``, by default
``build/dryrun_results.json``; cells already there are run again).  griffin and xlstm hold their recurrent
states whole over ``model`` with the batch split as the activations are
(the route that gathers their leaves, models/griffin.py); for them
``cache_held_bytes`` is what the program holds and ``cache_bytes`` what
``cache_specs`` implies (which leaves some states' batch whole).  Runs on the CPU; needs no
card.

``--fl-round ARCH --compress MODE`` (repeatable) runs the paper's FL round
instead (:func:`run_fl_round_cell`, the JAX package's "paper-representative
roofline cell"): on the production 16 x 16 mesh unless ``--mesh`` names
others, every slice of the cohort axes a cohort with train_4k's batch cut
evenly over them, one local SGD step (lr 0.05, momentum 0.9) with tensor
parallelism over ``model``, then the masked FedAvg of
``distributed/fl_parallel.make_fl_round`` in that wire format.  It reports
the stacked parameter and optimizer bytes a rank (``local_bytes`` of the
stacked specs), FLOPs and the collectives by kind.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import fl_parallel, sharding
from repro_torch.launch.mesh import parse_mesh, production_shapes
from repro_torch.launch.steps import build_cell
from repro_torch.models.layers import ModelParallel
from repro_torch.models.registry import FAMILY_MODULES, build, list_archs
from repro_torch.optim.sgd import OptimizerConfig
from repro_torch.utils.trees import tree_leaves, tree_map

RESULTS = (Path(__file__).resolve().parents[3] / "build"
           / "dryrun_results.json")
CARD_BYTES = 80e9              # one H100's device memory
GATHER_FAMILIES = ("griffin", "xlstm")


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0;
    destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _held_state_specs(api, cell, sizes: dict):
    """The specs of the states griffin and xlstm hold: each leaf's batch
    dim (the one that grows with the batch, found from two ``meta``
    ``init_states``) over the batch axes as ``batch_specs`` splits the
    inputs, every other dim whole."""
    fam = importlib.import_module(FAMILY_MODULES[api.cfg.family])
    one, two = (fam.init_states(api.cfg, b, device="meta") for b in (1, 2))
    flat = {}
    sharding.map_with_path(lambda p, x: flat.__setitem__(p, x.shape), two)
    batch = sharding.batch_specs({"x": torch.empty(
        (cell.global_batch,), device="meta")}, sizes)["x"][0]

    def held(path, x):
        return sharding.Spec(batch if a != b else None
                             for a, b in zip(x.shape, flat[path]))
    return sharding.map_with_path(held, one)


# the leading dims each stacked subtree's init draws one at a time
STACKED_DIMS = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "groups": 1,
                "slstm": 1, "mlstm": 2}


def largest_draw_bytes(pshapes: dict) -> int:
    """Bytes of the largest tree an ``init`` draws whole: one draw of a
    stacked subtree (its leaves less their stacked dims), any other
    top-level subtree whole."""
    def draw(key, sub) -> int:
        lead = STACKED_DIMS.get(key, 0)
        leaves = sharding.spec_leaves(sub)
        return sum(x.numel() // math.prod(x.shape[:lead]) * x.dtype.itemsize
                   for x in leaves)
    return max(draw(k, v) for k, v in pshapes.items())


def run_cell(arch: str, shape: str, sizes: dict, *, reduced: bool = False,
             flops: bool = True) -> dict:
    """One cell on the mesh of axis ``sizes``: its record (module
    docstring)."""
    api = build(arch, reduced=reduced)
    ok, reason = api.supports(shape)
    if not ok:
        return {"status": "skip", "reason": reason}
    cell = SHAPES[shape]
    t0 = time.perf_counter()
    spec = build_cell(arch, shape, sizes, reduced=reduced)
    pshapes = spec.abstract_args[0]
    inputs = api.input_specs(shape)
    total, active = api.param_counts()
    rec = {"status": "ok", "arch": arch, "shape": shape,
           "mesh": "x".join(str(v) for v in sizes.values()),
           "axes": list(sizes), "n_devices": math.prod(sizes.values()),
           "reduced": reduced, "params_total": total,
           "params_active": active, "fsdp": spec.static["fsdp"],
           "param_bytes": sharding.local_bytes(pshapes, spec.param_specs,
                                               sizes),
           "input_bytes": sharding.local_bytes(inputs, spec.batch_specs,
                                               sizes),
           "opt_bytes": 0, "cache_bytes": 0}
    cache_held = None
    if cell.kind == "train":
        rec["opt_bytes"] = sharding.local_bytes(spec.abstract_args[1],
                                                spec.opt_specs, sizes)
    if cell.kind == "decode":
        cshapes = spec.abstract_args[1]
        rec["cache_bytes"] = sharding.local_bytes(cshapes, spec.cache_specs,
                                                  sizes)
        cache_held = spec.cache_specs
        if api.cfg.family in GATHER_FAMILIES:
            cache_held = _held_state_specs(api, cell, sizes)
        rec["cache_held_bytes"] = sharding.local_bytes(cshapes, cache_held,
                                                       sizes)
    held = rec.get("cache_held_bytes", rec["cache_bytes"])
    rec["rank_bytes"] = (rec["param_bytes"] + rec["opt_bytes"] + held
                         + rec["input_bytes"])
    rec["init_bytes"] = rec["param_bytes"] + largest_draw_bytes(pshapes)
    rec["fits_80gb"] = max(rec["rank_bytes"], rec["init_bytes"]) \
        <= CARD_BYTES
    rec["params_fit"] = rec["param_bytes"] <= CARD_BYTES
    if flops:
        rec.update(_run_rank(api, spec, cell, sizes, inputs, cache_held))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _run_rank(api, spec, cell, sizes: dict, inputs, cache_specs) -> dict:
    """Rank 0's step on its meta blocks: FLOPs and collectives."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    with fake_world(math.prod(sizes.values())):
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        params = sharding.shard_params(spec.abstract_args[0],
                                       spec.param_specs, mesh)
        batch = sharding.shard_params(inputs, spec.batch_specs, mesh)
        mp = ModelParallel.of(mesh, spec.param_specs,
                              global_batch=cell.global_batch)
        out = {"flops_of": cell.kind}
        if cell.kind == "train":
            forward = FlopCounterMode(display=False)
            with torch.no_grad(), forward:
                api.loss_fn(params, batch, mp=mp)
            out["forward_flops"] = int(forward.get_total_flops())
            opt = sharding.shard_params(spec.abstract_args[1],
                                        spec.opt_specs, mesh)
        sharding.reset_collective_counts()
        counter = FlopCounterMode(display=False)
        if cell.kind == "train":
            with counter:
                spec.fn(params, opt, batch, mp=mp)
        else:
            with torch.inference_mode(), counter:
                if cell.kind == "prefill":
                    spec.fn(params, batch, mp=mp)
                else:
                    cache = sharding.shard_params(spec.abstract_args[1],
                                                  cache_specs, mesh)
                    spec.fn(params, cache, batch["tokens"],
                            spec.abstract_args[3], mp=mp)
        coll = {k: dict(v) for k, v in sharding.collective_counts.items()}
    return {**out, "flops": int(counter.get_total_flops()),
            "collectives": coll,
            "collective_bytes": sum(v["bytes"] for v in coll.values())}


def run_fl_round_cell(arch: str, compress: str, sizes: dict, *,
                      reduced: bool = False, flops: bool = True) -> dict:
    """The FL round of the module docstring on the mesh of axis
    ``sizes``: its record."""
    api = build(arch, reduced=reduced)
    cfg = api.cfg
    t0 = time.perf_counter()
    n_cohorts = math.prod(sizes[a] for a in sharding.cohort_axes(sizes))
    cell = SHAPES["train_4k"]
    per_cohort = cell.global_batch // n_cohorts
    opt = OptimizerConfig(name="sgd", lr=0.05, momentum=0.9).build()
    pshapes = api.param_shapes()
    pspecs = sharding.param_specs(pshapes, cfg, sizes, fsdp=False)
    sspecs = fl_parallel.stacked_param_specs(pspecs, sizes)
    stacked = tree_map(lambda x: x.new_empty((n_cohorts,) + x.shape),
                       pshapes)
    oshapes = {"step": torch.empty((n_cohorts,), dtype=torch.int32,
                                   device="meta"),
               "mu": tree_map(lambda x: x.new_empty(x.shape, dtype=torch.float32), stacked)}
    ospecs = sharding.opt_specs(oshapes, sspecs)
    total, active = api.param_counts()
    rec = {"status": "ok", "arch": arch, "compress": compress,
           "shape": "train_4k", "mesh": "x".join(map(str, sizes.values())),
           "axes": list(sizes), "n_devices": math.prod(sizes.values()),
           "reduced": reduced, "params_total": total,
           "params_active": active, "fsdp": False, "n_cohorts": n_cohorts,
           "cohort_batch": per_cohort,
           "param_bytes": sharding.local_bytes(stacked, sspecs, sizes),
           "opt_bytes": sharding.local_bytes(oshapes, ospecs, sizes)}
    if flops:
        rec.update(_run_fl_rank(api, opt, compress, sizes, pspecs, sspecs,
                                n_cohorts, per_cohort, cell.seq_len))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _run_fl_rank(api, opt, compress: str, sizes: dict, pspecs, sspecs,
                 n_cohorts: int, per_cohort: int, seq: int) -> dict:
    """Rank 0's FL round on its meta blocks: FLOPs and collectives."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    with fake_world(math.prod(sizes.values())):
        mesh = init_device_mesh("cpu", tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
        params = sharding.shard_params(api.param_shapes(), pspecs, mesh)
        here = n_cohorts // dist.get_world_size(
            fl_parallel.cohort_group(mesh))
        states = fl_parallel.init_cohort_states(
            opt, fl_parallel.stack_for_cohorts(params, here))
        batches = {"tokens": torch.empty((here, 1, per_cohort, seq),
                                         dtype=torch.int32, device="meta")}
        weights = torch.empty((n_cohorts,), device="meta")
        fl_round = fl_parallel.make_fl_round(api.loss_fn, opt, 1, mesh,
                                             sspecs, compress=compress)
        sharding.reset_collective_counts()
        counter = FlopCounterMode(display=False)
        with counter:
            fl_round(params, states, batches, weights)
        coll = {k: dict(v) for k, v in sharding.collective_counts.items()}
    return {"flops": int(counter.get_total_flops()), "flops_of": "fl_round",
            "collectives": coll,
            "collective_bytes": sum(v["bytes"] for v in coll.values())}


def _summary(rec: dict) -> str:
    """One cell's record as a line of the run's log."""
    if rec["status"] != "ok":
        return f"{rec['status']}: {rec.get('reason') or rec.get('error')}"
    if "rank_bytes" in rec:
        line = (f"{rec['rank_bytes'] / 1e9:.2f} GB a rank (params "
                f"{rec['param_bytes'] / 1e9:.2f}, opt "
                f"{rec['opt_bytes'] / 1e9:.2f}, cache "
                f"{rec['cache_bytes'] / 1e9:.2f}, inputs "
                f"{rec['input_bytes'] / 1e9:.3f}; init "
                f"{rec['init_bytes'] / 1e9:.2f}), fits 80 GB: "
                f"{rec['fits_80gb']}")
    else:
        line = (f"{rec['n_cohorts']} cohorts of batch {rec['cohort_batch']};"
                f" stacked params {rec['param_bytes'] / 1e9:.3f} GB a rank,"
                f" opt {rec['opt_bytes'] / 1e9:.3f}")
    if "flops" in rec:
        calls = {k: v["calls"] for k, v in rec["collectives"].items()
                 if v["calls"]}
        line += (f"; {rec['flops']:.3e} FLOPs ({rec['flops_of']}), "
                 f"collectives {rec['collective_bytes']:.3e} B {calls}")
    return line + f" [{rec['seconds']:.1f} s]"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", action="append", default=[],
                    help="another mesh DxM (or PxDxM), e.g. 1x4")
    ap.add_argument("--no-production", action="store_true",
                    help="leave out the 16x16 and 2x16x16 meshes")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--no-flops", action="store_true",
                    help="bytes from the specs only; run no program")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--fl-round", default=None, metavar="ARCH",
                    help="run the FL cohort round of ARCH instead of the "
                         "step cells (on 16x16 unless --mesh is given)")
    ap.add_argument("--compress", action="append", default=None,
                    choices=list(fl_parallel.COMPRESS),
                    help="the FL round's wire format (repeatable; none)")
    args = ap.parse_args(argv)
    if args.fl_round:
        meshes = ({m: parse_mesh(m) for m in args.mesh} if args.mesh else
                  {"16x16": production_shapes()["16x16"]})
        cells = [(f"fl-round-{mode}|{args.fl_round}", mode)
                 for mode in args.compress or ["none"]]
    else:
        meshes = {} if args.no_production else production_shapes()
        meshes.update({m: parse_mesh(m) for m in args.mesh})
        cells = [(f"{arch}|{shape}", shape)
                 for arch in args.arch or list_archs()
                 for shape in args.shape or list(SHAPES)]
    out = Path(args.out)
    res = json.loads(out.read_text()) if out.exists() else {}
    failures = []
    for mname, sizes in meshes.items():
        for cell, what in cells:
            key = f"{cell}|{mname}" + ("|reduced" if args.reduced else "")
            try:
                if args.fl_round:
                    rec = run_fl_round_cell(
                        args.fl_round, what, sizes, reduced=args.reduced,
                        flops=not args.no_flops)
                else:
                    rec = run_cell(cell.split("|")[0], what, sizes,
                                   reduced=args.reduced,
                                   flops=not args.no_flops)
            except Exception as e:       # a failed cell is a bug
                rec = {"status": "fail",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                failures.append(key)
            res[key] = rec
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(res, indent=1, sort_keys=True))
            print(f"[{key}] {_summary(rec)}", flush=True)
    n_ok = sum(r["status"] == "ok" for r in res.values())
    print(f"done: {n_ok} ok of {len(res)} in {out}; {len(failures)} "
          f"failed")
    if failures:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
