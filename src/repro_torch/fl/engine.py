"""Learning-coupled FL engine: accuracy-versus-time curves on one device —
the PyTorch port of ``repro.fl.engine`` (single device, flat selection,
synchronous rounds).

The paper's headline evaluation (Figs. 4-6) is test accuracy against
elapsed time: a selection policy matters because faster rounds buy more
model updates per second.  Each round here runs the whole protocol: the
bandit round of ``repro_torch.sim.engine`` (polling, Eq. (8) draws,
selection, schedule, observe; the CUDA round kernel on the card), E local
epochs of minibatch SGD for every trained client at once, the weighted
FedAvg combine (the CUDA ``fedavg_combine`` kernel on the card, one launch
per round for all grid points), and the test accuracy of the new global
model.  The [G] grid axis holds the seeds (η is one scalar per sweep); the
policy axis and the rounds are host loops.

Parameters live flat.  The G global models are a [G, N] float32 buffer and
the round's client models a [G·C, N] buffer (C = K for ``cohort="all"``,
C = S for ``"selected"``); training writes through per-leaf views of the
rows (``utils/trees.views``) and the combine reads the [G, C, N] buffer as
it is.  One SGD step is a ``torch.func.vmap`` over the G·C client models of
``torch.func.grad`` of ``models/cnn.loss_fn``.  Each round's parts run
under ``torch.profiler`` ranges (``fl.bandit_round``, ``fl.local_sgd``,
``fl.aggregate``, ``fl.evaluate``), which cost nothing measurable when no
profiler is on and let a trace split a round's time between them.

Counterparts (JAX package -> here): ``PAPER_EPOCHS``/``PAPER_BATCH``,
``FlTask``/``make_cnn_task``, ``make_client_update``, ``make_evaluator``,
``_masked_fedavg`` -> :func:`masked_fedavg`, ``_train_round`` ->
:func:`train_round`, the protocol rounds -> :func:`run_fl_rounds`,
``run_replay``, ``FlSweepResult``, ``accuracy_sweep``, and the async
FedBuff twin ``_async_fl_segment`` -> :func:`async_fl_segment`,
``async_accuracy_run``.  The clients' epoch orders are an input (``order``
[.., E, cap], positions into each client's shard), drawn by the sweep from
its ``"perm"`` stream (:func:`draw_orders`): the tests hand both packages
the same orders.  ``accuracy_sweep`` spreads its grid or its clients'
bandit state over the ranks of a ``torch.distributed`` process group
(``devices``, ``shard``; distributed/sharding.py).  The host-loop twin of
:func:`run_replay`, ``run_host_reference``, trains one client at a time
through ``fl/server.LocalTrainer`` and ``fl/aggregation.fedavg``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import bandit
from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        pad_partitions)
from repro_torch.data.synthetic import make_synthetic_cifar
from repro_torch.distributed import sharding
from repro_torch.fl import metrics
from repro_torch.fl.aggregation import GUARD_MAX_NORM, fedavg
from repro_torch.fl.server import LocalTrainer
from repro_torch.kernels import ops
from repro_torch.models import cnn
from repro_torch.optim.sgd import PAPER_LR0, PAPER_LR_DECAY, round_lrs
from repro_torch.sim import async_engine as ae
from repro_torch.sim import engine as sim
from repro_torch.sim.scenarios import Scenario, get_scenario
from repro_torch.utils.trees import (FlatSpec, flatten, tree_bytes,
                                     unflatten, views)

# Paper Sect. IV-B local recipe (the lr side lives in optim/sgd.py).
PAPER_EPOCHS = 5
PAPER_BATCH = 50


# ---------------------------------------------------------------------------
# Task
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlTask:
    """The FL task on one device: global data, padded per-client shards,
    per-client mean resources and the initial model.

    Images are stored NCHW (the JAX package stores NHWC).  ``part_idx`` is
    [K, cap] into ``train_x`` (cap a multiple of the batch size; padding
    repeats the first index and is masked by ``part_count``).  The test set
    is pre-chunked [n_chunks, B, ...], padded with zero images that
    ``test_mask`` excludes.
    """

    env: sim.EnvArrays          # per-client mean resources (time side)
    params0: dict               # initial model, the port's layout
    train_x: torch.Tensor       # [N, 3, H, W] f32
    train_y: torch.Tensor       # [N] int64
    test_x: torch.Tensor        # [n_chunks, B, 3, H, W] f32
    test_y: torch.Tensor        # [n_chunks, B] int64
    test_mask: torch.Tensor     # [n_chunks, B] bool
    part_idx: torch.Tensor      # [K, cap] int64
    part_count: torch.Tensor    # [K] int64

    @property
    def n_clients(self) -> int:
        return int(self.part_count.shape[0])

    @property
    def device(self) -> torch.device:
        return self.train_x.device


def make_cnn_task(scenario: Scenario | str = "paper-baseline",
                  n_clients: int = 100, *,
                  cfg: cnn.CnnConfig = cnn.CnnConfig(),
                  n_train: int = 50_000, n_test: int = 10_000,
                  seed: int = 0, env_seed: int = 0,
                  partition: str = "iid", dirichlet_alpha: float = 0.5,
                  batch_size: int = PAPER_BATCH, eval_batch: int = 500,
                  max_samples: int | None = None, params0: dict | None = None,
                  device=None) -> FlTask:
    """Build the paper's CIFAR task, as the JAX package's ``make_cnn_task``
    does: the same seeds give the same images, client resources and shards.

    Client dataset sizes are the scenario environment's D_k (``max_samples``
    clips them).  ``partition`` is "iid" (paper) or "dirichlet".
    ``params0`` (a parameter dict in the port's layout, e.g. from
    ``repro_torch.convert.cnn_params_from_jax``) replaces the port's own
    He-normal init, which draws from a CPU ``torch.Generator`` seeded with
    ``seed`` so that every device starts from the same weights.  ``device``
    None means the card.
    """
    device = sim.resolve_device(device)
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    train, test = make_synthetic_cifar(n_train=n_train, n_test=n_test,
                                       size=cfg.image_size, seed=seed)
    env = scen.build_env(n_clients, np.random.default_rng(env_seed))
    if max_samples is not None:
        env = dataclasses.replace(
            env, n_samples=np.minimum(env.n_samples, max_samples))
    rng = np.random.default_rng(seed + 1)
    if partition == "iid":
        parts = iid_partition(train, env.n_samples, rng)
    elif partition == "dirichlet":
        parts = dirichlet_partition(train, env.n_samples, dirichlet_alpha,
                                    rng, n_classes=cfg.n_classes)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    idx, count = pad_partitions(parts, round_to=batch_size)

    n_chunks = math.ceil(len(test.y) / eval_batch)
    pad = n_chunks * eval_batch - len(test.y)
    tx = np.concatenate([test.x, np.zeros((pad,) + test.x.shape[1:],
                                          test.x.dtype)])
    ty = np.concatenate([test.y, np.zeros(pad, test.y.dtype)])
    tm = np.arange(n_chunks * eval_batch) < len(test.y)

    if params0 is None:
        params0 = cnn.init(torch.Generator().manual_seed(seed), cfg)

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return FlTask(
        env=sim.EnvArrays.from_scenario(scen, env, device),
        params0={n: p.to(device, torch.float32) for n, p in params0.items()},
        train_x=nchw(train.x), train_y=t(train.y, torch.int64),
        test_x=nchw(tx).reshape(n_chunks, eval_batch, 3, cfg.image_size,
                                cfg.image_size),
        test_y=t(ty, torch.int64).reshape(n_chunks, eval_batch),
        test_mask=t(tm, torch.bool).reshape(n_chunks, eval_batch),
        part_idx=t(idx, torch.int64), part_count=t(count, torch.int64))


# ---------------------------------------------------------------------------
# Client update, evaluation, aggregation
# ---------------------------------------------------------------------------

def draw_orders(gen: torch.Generator, n_seeds: int, count: torch.Tensor,
                epochs: int, cap: int) -> torch.Tensor:
    """Every client's epoch orders for one round, [G, K, E, cap] int64
    positions into its shard: a stable ``argsort`` of uniforms plus 2 at the
    padding positions (>= the client's count), so padding sorts last — the
    JAX package's ``argsort(uniform + 2·(pos >= count))`` idiom."""
    u = torch.rand((n_seeds, count.shape[0], epochs, cap), generator=gen,
                   device=count.device)
    pad = torch.arange(cap, device=count.device) >= count[:, None, None]
    return (u + 2.0 * pad).argsort(dim=-1, stable=True)


def make_client_update(cfg: cnn.CnnConfig, *, epochs: int, batch_size: int):
    """The paper's per-round client recipe, E epochs of minibatch SGD over
    each client's padded shard, for M client models at once:

        client_update(rows, spec, train_x, train_y, idx, count, lr, order)

    ``rows``: [M, N] flat client models, updated in place; ``idx``: [M, cap]
    shard indices; ``count``: [M] true shard sizes; ``order``: [M, E, cap]
    positions (each epoch's shuffle); ``lr``: the round's float32 rate, a
    Python number or a 0-dim float32 tensor on the rows' device.
    Batch b of an epoch takes positions [b·B, (b+1)·B) of the order and is
    applied only by clients whose count covers it (``(b+1)·B <= count``):
    the rest keep their parameters, as the JAX package's masked scan does.
    Batches that no client covers are skipped.
    """
    def loss(params, x, y):
        return cnn.loss_fn(params, x, y, cfg)
    grad_fn = torch.func.vmap(torch.func.grad(loss))

    def client_update(rows, spec, train_x, train_y, idx, count, lr, order):
        m, cap = idx.shape
        n_b = cap // batch_size
        batches = idx.gather(1, order.reshape(m, -1)).reshape(
            m, epochs, n_b, batch_size)
        n_live = int(count.max()) // batch_size    # batches some client uses
        params = views(rows, spec)
        if not isinstance(lr, torch.Tensor):      # a tensor stays on device
            lr = float(np.float32(lr))
        for e in range(epochs):
            for b in range(min(n_live, n_b)):
                bidx = batches[:, e, b]
                grads = grad_fn(params, train_x[bidx], train_y[bidx])
                ok = (b + 1) * batch_size <= count
                for name, p in params.items():
                    keep = ok.view(-1, *([1] * (p.dim() - 1)))
                    p.copy_(torch.where(keep, p - lr * grads[name], p))
    return client_update


def make_evaluator(cfg: cnn.CnnConfig):
    """Test accuracy of G models over the pre-chunked test set:

        evaluate(rows [G, N], spec, test_x, test_y, test_mask) -> [G] f32

    BatchNorm uses each chunk's own statistics, padding included, exactly
    as the JAX package's evaluator does."""
    fwd = torch.func.vmap(lambda p, x: cnn.forward(p, x, cfg),
                          in_dims=(0, None))

    @torch.no_grad()
    def evaluate(rows, spec, test_x, test_y, test_mask):
        params = views(rows, spec)
        correct = torch.zeros(rows.shape[0], dtype=torch.int64,
                              device=rows.device)
        for c in range(test_x.shape[0]):
            pred = fwd(params, test_x[c]).argmax(-1)
            correct += ((pred == test_y[c]) & test_mask[c]).sum(-1)
        return correct.float() / max(int(test_mask.sum()), 1)
    return evaluate


def masked_fedavg(rows: torch.Tensor, weights: torch.Tensor,
                  guard: bool = False):
    """Weighted FedAvg of [G, C, N] client rows with [G, C] weights (the
    selection mask arrives as zero weights) -> [G, N], through
    ``kernels/ops.fedavg_combine``: one launch of the CUDA kernel for all G
    grid points on the card, the plain version on the CPU.

    ``guard`` rejects rows that hold a non-finite value or whose L2 norm
    exceeds ``GUARD_MAX_NORM``: their weight is zeroed and, in place, their
    values too (a NaN times a zero weight is still NaN).  Returns
    ``(avg, w_guarded, n_rejected [G])`` with the guard, ``avg`` without.
    """
    if guard:
        norm = torch.linalg.vector_norm(rows, dim=-1)
        row_ok = torch.isfinite(rows).all(-1) & (norm <= GUARD_MAX_NORM)
        n_rejected = ((weights > 0.0) & ~row_ok).sum(-1, dtype=torch.int32)
        weights = torch.where(row_ok, weights, 0.0)
        rows.masked_fill_(~row_ok[..., None], 0.0)
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    avg = ops.fedavg_combine(rows, w.contiguous())
    return (avg, weights, n_rejected) if guard else avg


def train_round(params: torch.Tensor, sel: torch.Tensor, task: FlTask, lr,
                order: torch.Tensor, spec: FlatSpec, *, client_update,
                cohort: str, flags: torch.Tensor | None = None):
    """One round of local training and masked aggregation for G grid points.

    ``params``: [G, N] global models; ``sel``: [G, S] selections (-1
    padded); ``order``: [G, K, E, cap] every client's epoch orders, so a
    client trains the same trajectory whether it ran among all K
    (``cohort="all"``: unselected clients train too and aggregate with
    weight 0) or in a selected slot (``"selected"``).

    ``flags`` ([G, S] FLAG_* outcomes, failure-aware rounds) splits the
    dispatched cohort: crashed, churned and late slots never arrive (weight
    0); FLAG_CORRUPT slots arrive but their rows are poisoned with NaN here,
    for the aggregation guard to reject.  A grid point with no surviving
    update keeps its previous model.  Returns the new [G, N] models, and
    ``n_rejected`` [G] with ``flags``.
    """
    failure = flags is not None
    g, n = params.shape
    k, cap = task.part_idx.shape
    valid = sel >= 0
    arrived = (valid & ((flags == bandit.FLAG_OK)
                        | (flags == bandit.FLAG_CORRUPT))
               if failure else valid)
    corrupt = valid & (flags == bandit.FLAG_CORRUPT) if failure else None
    safe = torch.where(valid, sel, 0).long()
    cnt = task.part_count.float()
    if cohort == "all":
        c = k
        idx = task.part_idx.expand(g, k, cap)
        count = task.part_count.expand(g, k)
        w = torch.zeros(g, k, device=params.device).scatter_add(
            1, safe, torch.where(arrived, cnt[safe], 0.0))
        if failure:     # padding slots scatter to the dropped column K
            drop = torch.where(valid, sel, k).long()
            bad = torch.zeros(g, k + 1, dtype=torch.bool,
                              device=params.device).scatter(
                1, drop, corrupt)[:, :k]
    elif cohort == "selected":
        c = sel.shape[1]
        idx = task.part_idx[safe]
        count = task.part_count[safe]
        order = order.gather(1, safe[..., None, None].expand(
            -1, -1, *order.shape[2:]))
        w = torch.where(arrived, cnt[safe], 0.0)
        bad = corrupt
    else:
        raise ValueError(f"unknown cohort {cohort!r}")
    rows = params.repeat_interleave(c, dim=0)       # [G·C, N], a copy
    with record_function("fl.local_sgd"):
        client_update(rows, spec, task.train_x, task.train_y,
                      idx.reshape(g * c, cap), count.reshape(g * c), lr,
                      order.reshape(g * c, *order.shape[2:]))
    rows = rows.view(g, c, n)
    with record_function("fl.aggregate"):
        if not failure:
            new = masked_fedavg(rows, w)
            # an all-padding selection (fewer candidates than S) keeps the
            # model
            return torch.where(valid.any(1, keepdim=True), new, params)
        rows.masked_fill_(bad[..., None], float("nan"))
        new, w_ok, n_rejected = masked_fedavg(rows, w, guard=True)
        keep = (w_ok.sum(1) > 0.0)[:, None]
        return torch.where(keep, new, params), n_rejected


# ---------------------------------------------------------------------------
# The protocol rounds
# ---------------------------------------------------------------------------

def _round_lr(r: int) -> float:
    """Round ``r``'s (0-based) lr: element r of ``optim/sgd.round_lrs``."""
    return float(round_lrs(r + 1)[r])


def run_fl_rounds(task: FlTask, eta: torch.Tensor,
                  draws: Iterable[tuple[sim.RoundDraws, torch.Tensor]], *,
                  policy: str, scen: Scenario, s_round: int, hyper: float,
                  model_bits: float, epochs: int, batch_size: int,
                  cohort: str, cfg: cnn.CnnConfig, fluctuate: bool = True,
                  fast: bool = False, fused: bool = True,
                  deadline: float | None = None, shards=None) -> dict:
    """One learning-coupled round per element of ``draws`` — (RoundDraws,
    [G, K, E, cap] orders) pairs — for the [G] grid of ``eta``: the bandit
    round (``sim.engine.RoundRunner``; ``fused=False`` the unfused mask
    pipeline; ``shards`` its client-sharded segmented round), local
    training, the combine and the test accuracy.

    Returns a dict of ``round_times`` [G, R], ``accuracy`` [G, R],
    ``selected`` [G, R, S], ``flags`` [G, R, S] (None without a deadline)
    and the final global models ``params`` [G, N].
    """
    runner = sim.RoundRunner(task.env, eta, policy=policy, scen=scen,
                             s_round=s_round, hyper=hyper,
                             model_bits=model_bits, fluctuate=fluctuate,
                             fast=fast, fused=fused, deadline=deadline,
                             shards=shards)
    spec = FlatSpec.of_tree(task.params0)
    params = flatten(task.params0, spec).expand(eta.shape[0], -1).contiguous()
    client_update = make_client_update(cfg, epochs=epochs,
                                       batch_size=batch_size)
    evaluate = make_evaluator(cfg)
    rts, accs, sels, flags = [], [], [], []
    for r, (d, order) in enumerate(draws):
        with record_function("fl.bandit_round"):
            sel, rt, fl = runner.step(r + 1, d)
        out = train_round(params, sel, task, _round_lr(r), order, spec,
                          client_update=client_update, cohort=cohort,
                          flags=fl)
        params = out if fl is None else out[0]
        with record_function("fl.evaluate"):
            accs.append(evaluate(params, spec, task.test_x, task.test_y,
                                 task.test_mask))
        rts.append(rt)
        sels.append(sel)
        flags.append(fl)
    return {"round_times": torch.stack(rts, 1),
            "accuracy": torch.stack(accs, 1),
            "selected": torch.stack(sels, 1),
            "flags": None if deadline is None else torch.stack(flags, 1),
            "params": params}


def run_replay(task: FlTask, hyper: float, cand_masks, t_ud, t_ul, orders, *,
               policy: str, s_round: int, epochs: int = PAPER_EPOCHS,
               batch_size: int = PAPER_BATCH, cohort: str = "all",
               cfg: cnn.CnnConfig = cnn.CnnConfig(),
               rand_rounds=None) -> dict:
    """R learning-coupled rounds of one run from precomputed inputs, through
    the unfused mask pipeline — the port of the JAX package's
    ``run_replay``.

    ``cand_masks``: [R, K] bool; ``t_ud``/``t_ul``: [R, K]; ``orders``:
    [R, K, E, cap] epoch orders (the JAX package draws them from its
    ``perm_keys``; the tests derive them with its idiom); ``rand_rounds``:
    [R, K] uniforms of the random policy.  Returns numpy ``round_times``,
    ``elapsed`` (cumulative, float32, summed on the host in order),
    ``accuracy``, ``selected`` [R, S] and the final global ``params`` dict.
    """
    bandit.check_policy(policy)
    device = task.device

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    masks, t_ud, t_ul = t(cand_masks, torch.bool), t(t_ud), t(t_ul)
    orders = t(orders, torch.int64)
    rand = None if rand_rounds is None else t(rand_rounds)
    decay = bandit.policy_decay(policy)
    state = bandit.BanditState.create(1, masks.shape[1], device=device)
    spec = FlatSpec.of_tree(task.params0)
    params = flatten(task.params0, spec)[None]
    client_update = make_client_update(cfg, epochs=epochs,
                                       batch_size=batch_size)
    evaluate = make_evaluator(cfg)
    rts, accs, sels = [], [], []
    for r in range(masks.shape[0]):
        state, sel, rt = bandit.round_via_mask(
            state, masks[r][None], t_ud[r][None], t_ul[r][None],
            None if rand is None else rand[r][None], hyper, policy=policy,
            s_round=s_round, decay=decay)
        params = train_round(params, sel, task, _round_lr(r), orders[r][None],
                             spec, client_update=client_update,
                             cohort=cohort)
        accs.append(evaluate(params, spec, task.test_x, task.test_y,
                             task.test_mask)[0])
        rts.append(rt[0])
        sels.append(sel[0])
    rts = torch.stack(rts).cpu().numpy()
    return {"round_times": rts, "elapsed": np.cumsum(rts),
            "accuracy": torch.stack(accs).cpu().numpy(),
            "selected": torch.stack(sels).cpu().numpy(),
            "params": unflatten(params[0], spec)}


def run_host_reference(task: FlTask, pre: dict, *,
                       scenario: Scenario | str = "paper-baseline",
                       policy: str = "elementwise_ucb",
                       hyper: float | None = None, s_round: int = 5,
                       cfg: cnn.CnnConfig = cnn.CnnConfig(),
                       epochs: int = PAPER_EPOCHS,
                       batch_size: int = PAPER_BATCH) -> dict:
    """The disconnected host loop the engine replaces — the port of the
    JAX package's ``run_host_reference``: per round the bandit round on
    one [1, K] state (``core.bandit.round_via_mask``), then
    ``fl/server.LocalTrainer`` trains the selected clients one at a time,
    one SGD step (``torch.func.grad`` of ``models/cnn.loss_fn``) per
    minibatch, and ``fl/aggregation.fedavg`` combines them by shard size
    (the FedAvg-combine kernel when the parameters lie on the card), then
    the test accuracy.

    It consumes :func:`run_replay`'s inputs from ``pre``: ``cand_masks``
    [R, K], ``t_ud``/``t_ul`` [R, K], ``orders`` [R, K, E, cap] (each
    client's epoch orders, drawn from the JAX package's ``perm_keys`` with
    its idiom when ``pre`` comes from JAX's ``run_host_reference``) and,
    for the random policy, ``rand`` [R, K].  A run is ``run_replay``'s
    common-random-number twin: the same selections and round times, the
    accuracy within float tolerance.  A round that selects no client still
    advances the learning-rate schedule.  ``scenario`` is checked only:
    churn has a state the replayed inputs cannot carry.  Returns numpy
    ``round_times``, ``elapsed``, ``accuracy``, ``selected`` [R, S], the
    final ``params`` dict and ``pre``.
    """
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if scen.churn_prob > 0.0:
        raise ValueError("the host reference only supports stateless "
                         "resource processes (churn_prob == 0)")
    bandit.check_policy(policy)
    if hyper is None:
        hyper = bandit.DEFAULT_HYPERS[policy]
    device = task.device

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    masks, t_ud, t_ul = t(pre["cand_masks"], torch.bool), t(pre["t_ud"]), \
        t(pre["t_ul"])
    orders = t(pre["orders"], torch.int64)
    rand = None if pre.get("rand") is None else t(pre["rand"])
    cap = task.part_idx.shape[1]
    grad = torch.func.grad(lambda p, x, y: cnn.loss_fn(p, x, y, cfg))

    def client_update(params, k, rnd):
        idx, count = task.part_idx[k], int(task.part_count[k])
        lr = float(np.float32(_round_lr(rnd)))
        p = dict(params)
        for e in range(epochs):
            perm = idx[orders[rnd, k, e]]
            for b in range(cap // batch_size):
                if (b + 1) * batch_size <= count:
                    bidx = perm[b * batch_size:(b + 1) * batch_size]
                    g = grad(p, task.train_x[bidx], task.train_y[bidx])
                    p = {n: v - lr * g[n] for n, v in p.items()}
        return p, float(count)

    def aggregate(global_params, results):
        return fedavg([p for p, _ in results], [w for _, w in results])

    trainer = LocalTrainer(task.params0, client_update, aggregate)
    state = bandit.BanditState.create(1, masks.shape[1], device=device)
    decay = bandit.policy_decay(policy)
    spec = FlatSpec.of_tree(task.params0)
    evaluate = make_evaluator(cfg)
    rts, accs, sels = [], [], []
    for r in range(masks.shape[0]):
        state, sel, rt = bandit.round_via_mask(
            state, masks[r][None], t_ud[r][None], t_ul[r][None],
            None if rand is None else rand[r][None], hyper, policy=policy,
            s_round=s_round, decay=decay)
        chosen = [int(x) for x in sel[0].tolist() if x >= 0]
        if chosen:
            trainer.train_round(chosen)
        else:                       # keep the lr round counter in sync
            trainer.rounds_done += 1
        accs.append(float(evaluate(flatten(trainer.params, spec)[None], spec,
                                   task.test_x, task.test_y,
                                   task.test_mask)[0]))
        rts.append(rt[0])
        sels.append(sel[0])
    rts = torch.stack(rts).cpu().numpy()
    return {"round_times": rts, "elapsed": np.cumsum(rts),
            "accuracy": np.asarray(accs, np.float32),
            "selected": torch.stack(sels).cpu().numpy(),
            "params": trainer.params, "pre": pre}


# ---------------------------------------------------------------------------
# Public sweep API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlSweepResult:
    """Per-round traces for every (policy, seed) grid point, on the host."""

    policies: tuple[str, ...]
    hypers: tuple[float, ...]
    seeds: tuple[int, ...]
    eta: float
    round_times: np.ndarray     # [P, S, R]
    accuracy: np.ndarray        # [P, S, R]
    selected: np.ndarray        # [P, S, R, s_round] (-1 padded)
    # per-slot outcome flags (core.bandit.FLAG_*) when the sweep ran with a
    # round deadline; None on fault-free sweeps
    flags: np.ndarray | None = None    # [P, S, R, s_round] int32

    @property
    def elapsed(self) -> np.ndarray:
        """Cumulative elapsed time, [P, S, R]."""
        return np.cumsum(self.round_times, axis=-1)

    def toa(self, target: float) -> np.ndarray:
        """ToA@target per grid point, [P, S] (inf = never reached)."""
        return metrics.time_to_accuracy(self.elapsed, self.accuracy, target)

    def fault_counts(self) -> dict[str, np.ndarray]:
        """Per-grid-point outcome totals over all rounds and slots, [P, S]
        per category; the categories partition the dispatched slots.
        Requires a sweep run with a deadline."""
        if self.flags is None:
            raise ValueError("fault_counts() requires a sweep run with a "
                             "deadline (the failure-aware layer)")
        f = self.flags
        cat = {"ok": bandit.FLAG_OK, "crashed": bandit.FLAG_CRASH,
               "churned": bandit.FLAG_CHURN,
               "deadline_missed": bandit.FLAG_DEADLINE,
               "corrupt": bandit.FLAG_CORRUPT}
        out = {k: (f == v).sum(axis=(-2, -1)) for k, v in cat.items()}
        out["dispatched"] = (f >= 0).sum(axis=(-2, -1))
        return out

    def summary(self, targets: tuple[float, ...] = (0.5, 0.7, 0.8)) -> str:
        return metrics.toa_table(list(self.policies), self.elapsed,
                                 self.accuracy, targets)


def accuracy_sweep(scenario: Scenario | str = "paper-baseline",
                   policies=tuple(bandit.POLICY_NAMES),
                   seeds=2,
                   n_rounds: int = 100,
                   n_clients: int = 100,
                   s_round: int = 5,
                   frac_request: float = 0.1,
                   eta: float = 1.5,
                   *,
                   task: FlTask | None = None,
                   cfg: cnn.CnnConfig = cnn.CnnConfig(),
                   epochs: int = PAPER_EPOCHS,
                   batch_size: int = PAPER_BATCH,
                   cohort: str = "all",
                   use_kernel: bool | None = None,
                   fluctuate: bool = True,
                   model_bits: float | None = None,
                   devices=None,
                   shard: str = "grid",
                   chunk_rounds: int | None = None,
                   fused: bool = True,
                   fast_sampling: bool | None = None,
                   fast_perm: bool | None = None,
                   deadline: float | None = None,
                   device=None,
                   **task_kwargs) -> FlSweepResult:
    """Run the (policy x seed) accuracy-vs-time grid; the arguments are those
    of the JAX package's ``accuracy_sweep``, plus ``device`` (None = the
    card; ``"cpu"`` runs the plain PyTorch path).

    ``task`` defaults to ``make_cnn_task(scenario, n_clients, cfg=cfg,
    batch_size=batch_size, **task_kwargs)`` on ``device``; a prebuilt task
    must lie on ``device``.  ``model_bits`` defaults to the model's size in
    bits, the t_UL numerator.  ``deadline`` (seconds) switches on the
    failure-aware layer and the result's ``flags``.  Every policy of a seed
    sees the same random draws.  The aggregation routes by device: on the
    card one ``fedavg_combine`` launch per (policy, round), and the bandit
    round one launch of its kernel.  ``fused=False`` runs the unfused mask
    pipeline instead of the fused round, with the same results, as
    ``sim.engine.sweep(fused=)``.  ``use_kernel`` pins the route: True asks
    for the card's kernels and False for their plain versions, and either
    raises on the other device (None follows the device).  ``fast_perm``
    is moot here: the epoch orders are an input drawn by the sweep
    (:func:`draw_orders`), not a permutation chosen in the client update;
    it is accepted for the JAX package's signature.

    ``devices``, ``shard`` and ``chunk_rounds`` follow ``sim.engine.sweep``:
    P shards over the R ranks of the default process group, P/R each, every
    rank returning the whole result.  ``shard="grid"`` pads the seed axis
    to a multiple of R and runs each rank's seeds; selections and round
    times equal the flat sweep's bitwise, while the models and accuracy
    agree within the rounding of the vmapped convolutions, which depends on
    how many client models one call trains (on the CPU 2.4e-7 in a weight
    between 24 and 12 models a call).  ``shard="clients"`` splits the
    clients' bandit state and per-client means into P blocks and runs the
    segmented round on the streamed fused path when P divides K (else the
    flat round on every rank); every rank trains the round's whole cohort
    in one call and combines it (one ``fedavg_combine`` launch a round),
    so the results equal the flat sweep's bitwise.  With no group and no P
    it is the flat sweep, as in the JAX package.  ``chunk_rounds`` must
    divide ``n_rounds``; the draws are made a round at a time whatever it
    is, and the results are the unchunked ones bitwise.
    """
    del fast_perm                       # moot: the orders are an input
    if shard not in ("grid", "clients"):
        raise ValueError(f"unknown shard mode {shard!r}")
    sg = sharding.resolve_group(devices)
    sim.check_chunk_rounds(n_rounds, chunk_rounds)
    device = sim.resolve_device(device)
    # the kernels run on CUDA tensors and their plain versions on CPU ones
    if use_kernel is not None and bool(use_kernel) != (device.type == "cuda"):
        raise ValueError(
            f"use_kernel={use_kernel} on {device}: the kernels run on the "
            "card and their plain versions on the CPU; pass the matching "
            "device or use_kernel=None")
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if task is None:
        task = make_cnn_task(scen, n_clients, cfg=cfg, batch_size=batch_size,
                             device=device, **task_kwargs)
    elif task_kwargs:
        raise ValueError("pass either a prebuilt task or task_kwargs")
    elif task.device != device:
        raise ValueError(f"the task lies on {task.device}, the sweep runs on "
                         f"{device}")
    n_clients = task.n_clients
    if s_round > n_clients:
        raise ValueError(f"s_round={s_round} exceeds n_clients={n_clients}: "
                         f"cannot select more clients than exist")
    deadline = None if deadline is None else float(deadline)
    fault = bandit.resolve_fault(scen.fault, deadline)
    pol_names, hypers = [], []
    for p in policies:
        name, hyper = p if isinstance(p, tuple) else (p, None)
        bandit.check_policy(name)
        pol_names.append(name)
        hypers.append(float(bandit.DEFAULT_HYPERS[name]
                            if hyper is None else hyper))
    seeds = tuple(range(seeds)) if isinstance(seeds, int) else tuple(seeds)
    if model_bits is None:
        model_bits = 8.0 * tree_bytes(task.params0)
    n_req = math.ceil(n_clients * frac_request)
    fast = sim.resolve_fast_sampling(fast_sampling, n_clients)
    cap = task.part_idx.shape[1]
    n_seeds = len(seeds)
    grid = sg if shard == "grid" else None
    shards = (sg if sg is not None and shard == "clients" and fast and fused
              and sharding.even_shards(n_clients, sg.n_shards) is not None
              else None)
    rows = (None if grid is None
            else sharding.grid_rows(n_seeds, grid, device))
    g_eta = torch.full((n_seeds if rows is None else rows.shape[0],),
                       float(eta), device=device)

    def draw(gens, name):
        d = sim.draw_round_inputs(
            gens, n_seeds=n_seeds, n_etas=1, k=n_clients, n_req=n_req,
            s_round=s_round, fast=fast, fluctuate=fluctuate, policy=name,
            scen=scen, fault=fault)
        order = draw_orders(gens["perm"], n_seeds, task.part_count, epochs,
                            cap)
        if rows is None:
            return d, order
        return sim.take_rows(d, rows), order.index_select(0, rows)

    outs = []
    for name, hyper in zip(pol_names, hypers):
        gens = sim.make_generators(seeds, device)
        draws = (draw(gens, name) for _ in range(n_rounds))
        outs.append(run_fl_rounds(
            task, g_eta, draws, policy=name, scen=scen, s_round=s_round,
            hyper=hyper, model_bits=float(model_bits), epochs=epochs,
            batch_size=batch_size, cohort=cohort, cfg=cfg,
            fluctuate=fluctuate, fast=fast, fused=fused, deadline=deadline,
            shards=shards))

    def stack(key):
        x = torch.stack([o[key] for o in outs], 1)     # [G', P, R, ...]
        if grid is not None:
            x = sharding.gather_shards(x, 0, grid.group)[:n_seeds]
        return np.ascontiguousarray(x.transpose(0, 1).cpu().numpy())
    return FlSweepResult(
        policies=tuple(pol_names), hypers=tuple(hypers), seeds=seeds,
        eta=float(eta), round_times=stack("round_times"),
        accuracy=stack("accuracy"), selected=stack("selected"),
        flags=None if deadline is None else stack("flags"))


# ---------------------------------------------------------------------------
# Async serving twin: FedBuff-style staleness-weighted aggregation
# ---------------------------------------------------------------------------

def async_fl_segment(task: FlTask, state, buf_delta: torch.Tensor,
                     buf_w: torch.Tensor, params: torch.Tensor,
                     draws: Iterable, *, scen: Scenario,
                     acfg: ae.AsyncConfig, policy: str,
                     eta: float, model_bits: float, hyper: float,
                     epochs: int, batch_size: int, cfg: cnn.CnnConfig,
                     fluctuate: bool = True):
    """The learning-coupled async ticks (``_async_fl_segment``), one per
    element of ``draws`` (``sim.async_engine.TickDraws`` with ``orders``).

    Runs the time-only ticks (``sim.async_engine.run_segment``) with a
    model hook: the dispatched cohort trains from the current model ``params``
    [N], its deltas park in ``buf_delta`` [n_slots + 1, N] (written in
    place; the last row is the spare that dropped members land in) with
    their data weights in ``buf_w`` [n_slots], and each tick the first
    ``buffer_size`` completions apply as one FedBuff update, ``params +=
    Σ sw·delta / Σ sw`` with ``sw = D_k (1 + staleness)**-p``.  The sum is
    ``ops.fedavg_combine`` over ``buffer_size`` rows (fill slots gather
    slot 0 with weight 0): one launch of the CUDA kernel on the card per
    tick that aggregates.  lr follows the virtual round,
    ``paper_lr(n_aggregated / buffer_size)``.  Returns ``(state,
    buf_delta, buf_w, params, traces)``, the traces stacked to host numpy.
    """
    spec = FlatSpec.of_tree(task.params0)
    client_update = make_client_update(cfg, epochs=epochs,
                                       batch_size=batch_size)
    evaluate = make_evaluator(cfg)
    cnt = task.part_count.float()
    dev = params.device
    lr_decay = torch.tensor(PAPER_LR_DECAY, dtype=torch.float32, device=dev)

    def fedbuff(st, d, sel, target, agg_slots, agg_mask, staleness):
        nonlocal params, buf_w
        valid = sel >= 0
        safe = torch.where(valid, sel, 0).long()
        # the cohort trains from the model as of dispatch; lr paces with
        # model updates (one buffer flush ~ one sync round)
        lr = PAPER_LR0 * torch.pow(lr_decay, bandit.fdiv(
            st.n_aggregated.float(), acfg.buffer_size))
        rows = params.expand(acfg.s_dispatch, -1).clone()
        with record_function("fl.local_sgd"):
            client_update(rows, spec, task.train_x, task.train_y,
                          task.part_idx[safe], task.part_count[safe], lr,
                          d.orders[safe])
        buf_delta.index_copy_(0, target.long(), rows - params)
        buf_w = ae.put_drop(buf_w, target, torch.where(valid, cnt[safe], 0.0))
        with record_function("fl.aggregate"):
            in_range = agg_slots < acfg.n_slots
            safe_s = torch.where(in_range, agg_slots, 0).long()
            sw = (ae.staleness_weights(staleness[safe_s],
                                       acfg.staleness_power)
                  * buf_w[safe_s] * in_range)
            wsum = sw.sum()
            if bool(agg_mask.any()):    # the tick's one host read
                upd = ops.fedavg_combine(buf_delta[safe_s], sw)
                params = params + torch.where(
                    wsum > 0.0, upd / wsum.clamp_min(1e-9), 0.0)
        with record_function("fl.evaluate"):
            return {"accuracy": evaluate(params[None], spec, task.test_x,
                                         task.test_y, task.test_mask)[0]}

    state, traces = ae.run_segment(
        state, draws, scen, task.env, acfg, policy=policy, eta=eta,
        model_bits=model_bits, hyper=hyper, fluctuate=fluctuate,
        model=fedbuff)
    return state, buf_delta, buf_w, params, traces


def async_accuracy_run(scenario: Scenario | str = "paper-baseline",
                       policy: str = "elementwise_ucb",
                       *, n_ticks: int = 50, seed: int = 0,
                       acfg: ae.AsyncConfig | None = None,
                       task: FlTask | None = None,
                       n_clients: int = 100,
                       cfg: cnn.CnnConfig = cnn.CnnConfig(),
                       epochs: int = PAPER_EPOCHS,
                       batch_size: int = PAPER_BATCH,
                       eta: float = 1.5, model_bits: float | None = None,
                       hyper: float | None = None, fluctuate: bool = True,
                       fast_perm: bool | None = None,
                       draws: Iterable | None = None, device=None,
                       **task_kwargs) -> dict:
    """Serving-mode accuracy run: the bounded-staleness async protocol
    (``sim/async_engine.py``) coupled to local training, the port of the
    JAX package's ``async_accuracy_run``; the arguments are its, plus
    ``draws`` and ``device`` (None = the card; ``"cpu"`` the plain PyTorch
    path).

    Each tick dispatches a bandit-selected cohort that trains from the
    current model; the first ``acfg.buffer_size`` completions apply as one
    FedBuff update (:func:`async_fl_segment`).  ``draws`` (one
    ``TickDraws`` a tick, with ``orders`` [K, E, cap]) replay given random
    inputs; by default tick t draws ``async_engine.draw_tick(seed, t,
    ...)`` and its orders from the tick's ``"perm"`` generator.
    ``fast_perm`` is moot: the orders are an input.  The failure layer is
    not part of the twin, as in the JAX package: ``acfg.deadline`` must be
    None.  Returns per-tick ``dt``, ``elapsed``, ``accuracy``,
    ``selected``, ``admitted``, ``aggregated``, ``dropped`` and
    ``buffered`` traces, the final ``state`` and ``params`` (a dict in the
    port's layout).
    """
    del fast_perm                       # moot, see above
    device = sim.resolve_device(device)
    scen = get_scenario(scenario) if isinstance(scenario, str) else scenario
    acfg = acfg or ae.AsyncConfig()
    if acfg.deadline is not None:
        raise ValueError("the async FL twin has no failure layer (as the JAX "
                         "package's); pass an AsyncConfig with deadline=None")
    bandit.check_policy(policy)
    if task is None:
        task = make_cnn_task(scen, n_clients, cfg=cfg, batch_size=batch_size,
                             device=device, **task_kwargs)
    elif task_kwargs:
        raise ValueError("pass either a prebuilt task or task_kwargs")
    elif task.device != device:
        raise ValueError(f"the task lies on {task.device}, the run on "
                         f"{device}")
    if acfg.s_dispatch > task.n_clients:
        raise ValueError(f"s_dispatch={acfg.s_dispatch} exceeds "
                         f"n_clients={task.n_clients}")
    if hyper is None:
        hyper = bandit.DEFAULT_HYPERS[policy]
    if model_bits is None:
        model_bits = 8.0 * tree_bytes(task.params0)

    spec = FlatSpec.of_tree(task.params0)
    params = flatten(task.params0, spec)
    state = ae.AsyncState.create(task.env, acfg)
    buf_delta = torch.zeros((acfg.n_slots + 1, params.shape[0]),
                            device=device)
    buf_w = torch.zeros(acfg.n_slots, device=device)
    if draws is None:
        k, cap = task.n_clients, task.part_idx.shape[1]

        def draw(t):
            d = ae.draw_tick(seed, t, k=k, cfg=acfg, scen=scen,
                             policy=policy, fluctuate=fluctuate,
                             device=device)
            d.orders = draw_orders(ae.tick_generator(seed, "perm", t, device),
                                   1, task.part_count, epochs, cap)[0]
            return d
        draws = (draw(t) for t in range(n_ticks))
    state, _, _, params, tr = async_fl_segment(
        task, state, buf_delta, buf_w, params, draws, scen=scen, acfg=acfg,
        policy=policy, eta=eta, model_bits=float(model_bits),
        hyper=float(hyper), epochs=epochs, batch_size=batch_size, cfg=cfg,
        fluctuate=fluctuate)
    return {"dt": tr["dt"], "elapsed": tr["now"],
            "accuracy": tr["accuracy"], "selected": tr["selected"],
            "admitted": tr["admitted"], "aggregated": tr["aggregated"],
            "dropped": tr["dropped"], "buffered": tr["buffered"],
            "state": state, "params": unflatten(params, spec)}
