"""Run the port on several ``torch.distributed`` ranks from a test, on the
CPU.

:func:`run_ranks` spawns R processes with ``torch.multiprocessing.spawn``,
joins them in a gloo process group through a ``file://`` rendezvous in a
directory the caller owns (no TCP port, no ``MASTER_ADDR``/``MASTER_PORT``),
calls one function of this module on every rank, and returns every rank's
result to the parent.  A rank runs on one torch thread and destroys its
process group in a ``finally``; the run has a timeout, after which the
ranks are killed.

This module imports only ``torch``, ``numpy`` and ``repro_torch``: a
spawned rank imports it to find its function, and must not import JAX.
The rank functions take picklable arguments (numpy arrays, dicts, tuples)
and return numpy arrays.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_RUNS = itertools.count()


def one_thread():
    """The body of a fixture each port test module makes autouse and
    module-scoped: torch on one intra-op thread while the module's tests
    and fixtures run, the count restored after its last; the fixture's
    value is that count.  The suite runs six worker processes on eight
    CPUs; beside them, a pool of intra-op threads turns each of the port's
    many small CPU ops into a wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield n
    finally:
        torch.set_num_threads(n)


def run_ranks(fn, world: int, workdir: Path, *args, timeout: float = 300.0):
    """``[fn(rank, world, *args) for rank in range(world)]``, each call on
    its own gloo rank; ``fn`` is a function of this module."""
    run = Path(workdir) / f"ranks-{world}-{next(_RUNS)}"
    run.mkdir(parents=True)
    ctx = mp.spawn(_rank_main, args=(world, str(run), fn, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world} ranks of {fn.__name__} ran past "
                               f"{timeout} s")
    return [torch.load(run / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, run: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{run}/store",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(run) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def sweeps(rank: int, world: int, cases: dict, drawn: bool = False) -> dict:
    """``sim.engine.sweep(**kw)`` for each named case: round times and
    flags, and with ``drawn`` the values this rank drew
    (``SweepResult.drawn``)."""
    from repro_torch.sim import engine
    out = {}
    for name, kw in cases.items():
        res = engine.sweep(device="cpu", **kw)
        out[name] = ((res.round_times, res.flags, res.drawn) if drawn
                     else (res.round_times, res.flags))
    return out


def refusals(rank: int, world: int, cases: dict) -> dict:
    """The ValueError message of ``sim.engine.sweep(**kw)`` for each named
    case (None if it did not raise)."""
    from repro_torch.sim import engine
    out = {}
    for name, kw in cases.items():
        try:
            engine.sweep(device="cpu", **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def accuracy_sweeps(rank: int, world: int, task_kw: dict, cfg_kw: dict,
                    cases: dict) -> dict:
    """``fl.engine.accuracy_sweep`` on a small CNN task for each named case:
    selections, round times and accuracy."""
    from repro_torch.fl import engine
    from repro_torch.models import cnn
    cfg = cnn.CnnConfig(**cfg_kw)
    task = engine.make_cnn_task("paper-baseline", cfg=cfg, device="cpu",
                                **task_kw)
    out = {}
    for name, kw in cases.items():
        res = engine.accuracy_sweep(task=task, cfg=cfg, device="cpu", **kw)
        out[name] = (res.selected, res.round_times, res.accuracy)
    return out


def _cohorts(tree: dict, rank: int, per: int) -> dict:
    return {k: torch.as_tensor(v[rank * per:(rank + 1) * per])
            for k, v in tree.items()}


def cohort_combines(rank: int, world: int, stacked: dict, base: dict,
                    weights: np.ndarray, ratio: float) -> dict:
    """``fl_parallel.fedavg_across_cohorts`` of every compress mode on this
    rank's cohorts of ``stacked`` (flat dicts of numpy arrays)."""
    from repro_torch.distributed import fl_parallel
    group = dist.group.WORLD if dist.is_initialized() else None
    per = weights.shape[0] // world
    mine = _cohorts(stacked, rank, per)
    base_t = {k: torch.as_tensor(v) for k, v in base.items()}
    w = torch.as_tensor(weights)
    return {mode: {k: v.numpy() for k, v in fl_parallel.fedavg_across_cohorts(
        mine, w, compress=mode, topk_ratio=ratio, base_params=base_t,
        group=group).items()} for mode in fl_parallel.COMPRESS}


def cohort_rounds(rank: int, world: int, params: dict, batches: dict,
                  weights: np.ndarray, cfg_kw: dict, n_steps: int,
                  lr: float, ratio: float) -> dict:
    """One ``fl_parallel.make_fl_round`` of every compress mode on a small
    CNN with SGD, this rank's cohorts of ``batches``: the new global model
    and the mean loss."""
    from repro_torch.distributed import fl_parallel
    from repro_torch.models import cnn
    from repro_torch.optim.sgd import OptimizerConfig
    cfg = cnn.CnnConfig(**cfg_kw)
    group = dist.group.WORLD if dist.is_initialized() else None
    per = weights.shape[0] // world
    mine = _cohorts(batches, rank, per)
    p0 = {k: torch.as_tensor(v) for k, v in params.items()}
    opt = OptimizerConfig(name="sgd", lr=lr, lr_decay=0.0).build()

    def loss(p, b):
        return cnn.loss_fn(p, b["x"], b["y"], cfg)
    out = {}
    for mode in fl_parallel.COMPRESS:
        fl_round = fl_parallel.make_fl_round(loss, opt, n_steps,
                                             compress=mode, topk_ratio=ratio,
                                             group=group)
        states = fl_parallel.init_cohort_states(
            opt, fl_parallel.stack_for_cohorts(p0, per))
        new, _, mean_loss = fl_round(p0, states, mine, torch.as_tensor(
            weights))
        out[mode] = ({k: v.numpy() for k, v in new.items()},
                     float(mean_loss))
    return out


def cohort_checks(rank: int, world: int, combine: tuple, rounds: tuple
                  ) -> dict:
    """:func:`cohort_combines` and :func:`cohort_rounds` in one run."""
    return {"combine": cohort_combines(rank, world, *combine),
            "round": cohort_rounds(rank, world, *rounds)}


def _model_api(arch: str, dtype: str):
    """(family module, reduced config in ``dtype`` compute) of ``arch``;
    llava's with ``shard_attn_batch`` on, as its full config has it."""
    import dataclasses
    import importlib

    from repro_torch.models import registry
    cfg = registry.build(arch, reduced=True).cfg
    cfg = dataclasses.replace(cfg, compute_dtype=getattr(torch, dtype),
                              shard_attn_batch=cfg.family == "vlm")
    return importlib.import_module(registry.FAMILY_MODULES[cfg.family]), cfg


def lm_run(fam, cfg, params, batch, max_len: int, feed: np.ndarray,
           mp=None) -> dict:
    """One prefill and len(feed) decode steps fed the tokens ``feed`` [B,
    steps] (int32; this rank's rows): the prefill's and every step's
    logits, the greedy pick after each, and the collective counts of the
    prefill and of each step (with ``mp``)."""
    from repro_torch.distributed import sharding
    out = {"logits": [], "picks": [], "counts": []}
    with torch.inference_mode():
        sharding.reset_collective_counts()
        logits, cache, pos = fam.prefill(params, batch, cfg, max_len=max_len,
                                         mp=mp)
        for step in range(feed.shape[1] + 1):
            out["counts"].append({k: dict(v) for k, v in
                                  sharding.collective_counts.items()})
            out["logits"].append(logits.float().numpy())
            out["picks"].append(logits[:, -1].argmax(-1).numpy())
            if step == feed.shape[1]:
                break
            sharding.reset_collective_counts()
            logits, cache = fam.decode_step(
                params, cache, torch.as_tensor(feed[:, step]), pos + step,
                cfg, mp=mp)
    return out


def model_parallel(rank: int, world: int, cases: dict) -> dict:
    """Each case on a (data, model) mesh of this world: the reduced model's
    random parameters (seed 0) cut to this rank's blocks by ``param_specs``
    (with ``fsdp``), its batch rows by ``batch_specs``, then
    :func:`lm_run` through ``ModelParallel``.  A case: ``arch``, ``dtype``,
    ``mesh`` (data, model), ``fsdp``, ``batch`` (numpy arrays, bfloat16
    ones as float32), ``max_len``, ``feed`` [B, steps], and optionally
    ``params`` (the JAX package's tree as a nested dict of numpy arrays)
    and ``reference`` (rank 0 also runs the one-process path)."""
    from repro_torch import convert
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import ModelParallel
    out = {}
    for name, c in cases.items():
        fam, cfg = _model_api(c["arch"], c["dtype"])
        mesh = make_mesh(*c["mesh"], device_type="cpu")
        params = (convert.lm_params_from_tree(c["params"]) if "params" in c
                  else fam.init(torch.Generator().manual_seed(0), cfg))
        batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
        for k in ("patch_embeds", "frames"):
            if k in batch:                       # drawn in bfloat16
                batch[k] = batch[k].to(torch.bfloat16)
        if c.get("reference") and rank == 0:
            out[name + ":reference"] = lm_run(fam, cfg, params, batch,
                                              c["max_len"], c["feed"])
        pspecs = sharding.param_specs(params, cfg, mesh, fsdp=c["fsdp"])
        bspecs = sharding.batch_specs(batch, mesh)
        b = batch["tokens"].shape[0]
        mp = ModelParallel.of(mesh, pspecs, global_batch=b)
        rows = sharding.shard_leaf(torch.arange(b), bspecs["tokens"][:1],
                                   mp.coords, mp.sizes)
        out[name] = lm_run(fam, cfg, sharding.shard_params(params, pspecs,
                                                           mesh),
                           sharding.shard_params(batch, bspecs, mesh),
                           c["max_len"], c["feed"][rows.numpy()], mp)
        out[name]["rows"] = rows.numpy()
    return out


# ---------------------------------------------------------------------------
# training over a (data, model) mesh (tests/test_torch_mesh_train.py)
# ---------------------------------------------------------------------------

def _flat(tree) -> dict:
    from repro_torch.distributed import sharding
    out = {}
    sharding.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _numpy_tree(tree) -> dict:
    return {p: x.detach().float().numpy() for p, x in _flat(tree).items()}


def _train_case(c: dict):
    """(family module's api, cfg, params, batches) of a train case: the
    reduced ``arch`` in float32 compute (``remat`` as the case says), its
    parameters from seed 0 and the case's numpy batches."""
    import dataclasses
    import functools

    from repro_torch.models import registry
    fam, cfg = _model_api(c["arch"], "float32")
    cfg = dataclasses.replace(cfg, remat=c.get("remat", False))
    api = dataclasses.replace(
        registry.build(c["arch"], reduced=True), cfg=cfg,
        loss_fn=functools.partial(fam.loss_fn, cfg=cfg))
    params = fam.init(torch.Generator().manual_seed(0), cfg)
    batches = []
    for b in c["batches"]:
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        for k in ("patch_embeds", "frames"):
            if k in b:                           # drawn in bfloat16
                b[k] = b[k].to(torch.bfloat16)
        batches.append(b)
    return api, cfg, params, batches


def _train_run(api, params, batches, mp=None) -> dict:
    """AdamW steps (lr 3e-4, weight decay 0.1) of ``make_train_step`` on
    ``batches``: every step's loss; the first step's gradients, its
    updated parameters and both moments (``first``; this rank's blocks
    with ``mp``) and its collective calls; and whether that update is
    bitwise ``opt.update`` of the same blocks and gradients
    (``own_update``)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.steps import make_train_step, sum_over_batch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.optim.sgd import OptimizerConfig
    from repro_torch.utils.trees import tree_leaves
    step, opt = make_train_step(api, OptimizerConfig(
        name="adamw", lr=3e-4, weight_decay=0.1), mp=mp)
    loss_fn = api.loss_fn if mp is None else (
        lambda p, b: api.loss_fn(p, b, mp=mp))
    _, grads = value_and_grad(loss_fn, params, batches[0])
    if mp is not None:
        grads = sum_over_batch(grads, mp)
    state = opt.init(params)
    own = opt.update(grads, state, params)      # this block's own update
    losses, counts = [], None
    for i, b in enumerate(batches):
        sharding.reset_collective_counts()
        params, state, loss = step(params, state, b)
        if i == 0:
            counts = {k: v["calls"] for k, v in
                      sharding.collective_counts.items()}
            first = {"params": _numpy_tree(params),
                     "m": _numpy_tree(state["m"]),
                     "v": _numpy_tree(state["v"])}
            same = all(torch.equal(x, y) for t, u in (
                (own[0], params), (own[1]["m"], state["m"]),
                (own[1]["v"], state["v"]))
                for x, y in zip(tree_leaves(t), tree_leaves(u)))
        losses.append(float(loss))
    return {"losses": losses, "grads": _numpy_tree(grads), "first": first,
            "own_update": same, "counts": counts}


def mesh_train(rank: int, world: int, cases: dict) -> dict:
    """Each case's AdamW steps (:func:`_train_run`) on a (data, model) mesh
    of this world: the parameters cut to this rank's blocks by
    ``param_specs`` (with ``fsdp``), the batches' rows by ``batch_specs``.
    A case: ``arch``, ``mesh`` (data, model), ``fsdp``, ``remat``,
    ``batches`` (numpy; bfloat16 ones as float32) and ``reference`` (rank
    0 also runs the one-process steps).  Returns each case's run, its
    rank's mesh coordinates and, with ``reference``, the one-process run
    under ``name + ":reference"``."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import ModelParallel
    out = {}
    for name, c in cases.items():
        api, cfg, params, batches = _train_case(c)
        if c.get("reference") and rank == 0:
            out[name + ":reference"] = _train_run(api, params, batches)
        mesh = make_mesh(*c["mesh"], device_type="cpu")
        pspecs = sharding.param_specs(params, cfg, mesh, fsdp=c["fsdp"])
        bspecs = sharding.batch_specs(batches[0], mesh)
        mp = ModelParallel.of(mesh, pspecs,
                              global_batch=batches[0]["tokens"].shape[0])
        run = _train_run(api, sharding.shard_params(params, pspecs, mesh),
                         [sharding.shard_params(b, bspecs, mesh)
                          for b in batches], mp)
        run["coords"] = dict(mp.coords)
        out[name] = run
    return out


def mesh_fl_rounds(rank: int, world: int, params: dict, batches: dict,
                   weights: np.ndarray, n_steps: int, lr: float,
                   ratio: float) -> dict:
    """One ``fl_parallel.make_fl_round`` of every compress mode on a
    (data, model) = (C, world / C) mesh, C the cohorts of ``weights``:
    reduced smollm-135m in float32 compute from ``params`` (the JAX
    package's tree), SGD at ``lr``, this rank's cohort of ``batches``
    ({"tokens": [C, n_steps, B, S]}).  Returns this rank's mesh
    coordinates and, by mode, its block of the new global model and the
    mean loss."""
    import functools

    from repro_torch import convert
    from repro_torch.distributed import fl_parallel, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.sgd import OptimizerConfig
    fam, cfg = _model_api("smollm-135m", "float32")
    n = weights.shape[0]
    mesh = make_mesh(n, world // n, device_type="cpu")
    p0 = convert.lm_params_from_tree(params)
    pspecs = sharding.param_specs(p0, cfg, mesh, fsdp=False)
    sspecs = fl_parallel.stacked_param_specs(pspecs, mesh)
    mine = sharding.shard_params(p0, pspecs, mesh)
    coords = sharding.mesh_coords(mesh)
    toks = torch.as_tensor(batches["tokens"][coords["data"]:
                                             coords["data"] + 1])
    opt = OptimizerConfig(name="sgd", lr=lr, lr_decay=0.0).build()
    out = {"coords": coords}
    for mode in fl_parallel.COMPRESS:
        fl_round = fl_parallel.make_fl_round(
            functools.partial(fam.loss_fn, cfg=cfg), opt, n_steps, mesh,
            sspecs, compress=mode, topk_ratio=ratio)
        states = fl_parallel.init_cohort_states(
            opt, fl_parallel.stack_for_cohorts(mine, 1))
        new, _, loss = fl_round(mine, states, {"tokens": toks},
                                torch.as_tensor(weights))
        out[mode] = (_numpy_tree(new), float(loss))
    return out


def collective_functions(rank: int, world: int, seed: int) -> dict:
    """Each autograd collective of ``distributed/sharding.py`` on this
    rank, in float64 on integer-valued inputs (every sum exact in any
    order), drawn from ``seed`` for all ranks at once so the parent can
    rebuild them: the output, the input's gradient under this rank's
    upstream gradient, the output's ``grad_fn`` class name, the collective
    calls of the forward and of the backward, and the output with no
    gradient tracked."""
    from repro_torch.distributed import sharding
    rng = np.random.default_rng(seed)
    xs = rng.integers(-8, 9, (world, 3, 4)).astype(np.float64)
    cs = rng.integers(-8, 9, (world, 3, 4 * world)).astype(np.float64)
    grp = dist.group.WORLD
    calls = lambda: {k: v["calls"] for k, v in
                     sharding.collective_counts.items()}
    cases = {
        "sum_partials": (lambda x: sharding.sum_partials(x, grp), xs[rank],
                         cs[0, :, :4]),
        "copy_to_parallel": (lambda x: sharding.copy_to_parallel(x, grp),
                             xs[0], cs[rank, :, :4]),
        "gather_replicated": (lambda x: sharding.gather(x, 1, grp), xs[rank],
                              cs[0]),
        "gather_split": (lambda x: sharding.gather(x, 1, grp, split=True),
                         xs[rank], cs[rank]),
        "gather_split_rows": (lambda x: sharding.gather(x, 0, grp,
                                                        split=True),
                              xs[rank], cs[rank].reshape(3 * world, 4)),
    }
    out = {}
    for name, (fn, x, c) in cases.items():
        x = torch.tensor(x, requires_grad=True)
        sharding.reset_collective_counts()
        y = fn(x)
        fwd = calls()
        sharding.reset_collective_counts()
        (y * torch.as_tensor(c)).sum().backward()
        bwd = calls()
        with torch.no_grad():
            plain = fn(x.detach().clone())
        out[name] = {"y": y.detach().numpy(), "grad": x.grad.numpy(),
                     "grad_fn": type(y.grad_fn).__name__,
                     "forward_calls": fwd, "backward_calls": bwd,
                     "no_grad": plain.numpy()}
    return out


def mesh_checks(rank: int, world: int, seed: int, train: dict,
                fl: tuple | None = None) -> dict:
    """:func:`collective_functions`, :func:`mesh_train` and (with ``fl``
    the arguments after ``world``) :func:`mesh_fl_rounds` in one run."""
    out = {"functions": collective_functions(rank, world, seed),
           "train": mesh_train(rank, world, train)}
    if fl is not None:
        out["fl"] = mesh_fl_rounds(rank, world, *fl)
    return out
