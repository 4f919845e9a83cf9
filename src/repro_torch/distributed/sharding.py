"""Sharding over ``torch.distributed`` ranks — the port of
``repro.distributed.sharding``: its sweep half (``sweep_mesh``,
``pad_leading``, ``shard_vmapped``, ``shard_leading``, ``even_shards``,
``bandit_state_bytes``) plus the two cross-shard steps of the segmented
round, and its model half (the spec rules, below).

A JAX device is a rank here, one card each.  A sweep's ``devices`` = P
asks for P shards; :func:`resolve_group` spreads them over the R ranks of
the default process group as P/R contiguous blocks per rank (R must divide
P).  With no process group R = 1 and the one process holds every block;
then no collective runs.  Two layouts, as in the JAX package:

  * the grid layout (``shard="grid"``): the flattened (eta x seed) axis is
    edge-padded to a multiple of R (:func:`pad_leading`), each rank runs
    its rows (:func:`grid_rows`) and the results are all-gathered
    (:func:`gather_shards` along the rows), so every rank returns the
    whole grid;
  * the client layout (``shard="clients"``): shard p owns global clients
    [p*K/P, (p+1)*K/P).  On a rank the blocks are a leading [P/R] axis of
    tensors (:func:`shard_leading`, a view); ``psum`` is the local sum over
    that axis then ``all_reduce`` (:func:`sum_shards`) and ``all_gather``
    is an all-gather along it (:func:`gather_shards`).

A sharded :class:`~repro_torch.core.bandit.BanditState` holds one row per
(grid point, block of this rank): leaves of [G*P/R, K/P] (a reshape of
[G, P/R, K/P]), with the scalar counters ``total`` and ``disc_total``
replicated over the block rows, as each JAX shard keeps its own copy.

A collective runs on the tensors as they are: NCCL takes CUDA tensors and
gloo CPU ones, and a mismatch raises (no copy through the host).  JAX's
``replicate`` has no counterpart: every rank holds its own copy of what is
not sharded.

The model half (below) adds the spec rules of the LMs and the collectives
their model-parallel routes run (models/layers.py).  Under autograd (the
train step, launch/steps.py) each of those collectives is one of four
``torch.autograd.Function``\\ s, the conjugate pairs of tensor parallelism;
with no gradient tracked (serving) each is the plain collective:

  ====================  ==================  ==============================
  Function              forward             backward
  ====================  ==================  ==============================
  SumPartials           all_reduce          identity
  CopyToParallel        identity            all_reduce
  GatherReplicated      all_gather          this rank's slice
  GatherSplit           all_gather          reduce-scatter (sum, slice)
  ====================  ==================  ==============================

Which one a call site takes depends on what follows it, not on the
collective.  A gather whose result every rank of the axis uses for the same
work takes GatherReplicated; one whose result each rank uses on its own
share of the work (its batch rows, its query rows) takes GatherSplit.  The
two backward rules differ by a factor of the axis size, which shows only
in the gradients of earlier layers.  The call sites:

  ==============================================  =====================
  call site (models/)                              rule, axis
  ==============================================  =====================
  layers._row_sum: row-parallel wo and w_down,     SumPartials, model
  the experts' gated outputs
  layers.embed_apply, vocab over model             SumPartials, model
  layers.softmax_xent, batch split                 SumPartials, batch
  layers.moe_apply's routing means, batch split    SumPartials, batch
  the input of column-parallel wq/wk/wv (x, and a  CopyToParallel, model
  cross-attention's source), w_gate/w_up, the
  vocab-split unembedding; the experts' dispatch
  input and their gate weights
  q_norm/k_norm on the head- and context-parallel  CopyToParallel, model
  routes (applied to this rank's heads or rows)
  the context-parallel route's x                   CopyToParallel, model
  layers.vocab_logits: logits along the vocab      GatherReplicated, model
  transformer._embed_inputs: patch_proj's columns  GatherReplicated, model
  context-parallel output along the sequence       GatherReplicated, model
  ModelParallel.gather over model: gathered        GatherReplicated, model
  attention and MLP weights, the MoE's experts,
  griffin's and xlstm's gather-before-use leaves
  ModelParallel.gather over model on the           GatherSplit, model
  context-parallel route (wq, wk, wv, wo)
  ModelParallel.gather over data (FSDP), batch     GatherSplit, data
  split over data
  ModelParallel.gather over data, batch whole      GatherReplicated, data
  ==============================================  =====================

Serving alone runs the rest, with no gradient: split-KV decoding's
combine, the KV cache's gathers over the heads and the MoE's gather of
every rank's expert choices (integers).  With these rules a rank's
gradient of a replicated leaf is the same on every model rank and covers
its own batch rows; ``launch/steps.make_train_step`` sums it once over the
batch axes.  A leaf split over ``data`` (FSDP) is summed by its gather's
reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.distributed as dist

from repro_torch.core.bandit import BanditState


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """P shards over the R ranks of a process group (``group`` None: one
    process holding every block, no collectives)."""

    n_shards: int                 # P
    world: int = 1                # R
    rank: int = 0
    group: object | None = None

    @property
    def per_rank(self) -> int:
        """Blocks on each rank, P/R."""
        return self.n_shards // self.world

    @property
    def first(self) -> int:
        """Global index of this rank's first block."""
        return self.rank * self.per_rank


def place(n_shards: int, group=None) -> ShardGroup:
    """P shards over the ranks of the process group ``group`` (None: one
    process holding every block, no collectives); R must divide P."""
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{world} ranks")
    return ShardGroup(n_shards, world, rank, group)


def resolve_group(devices) -> ShardGroup | None:
    """A sweep's ``devices`` argument -> its :class:`ShardGroup` over the
    default process group when one is initialised, or None for the
    one-shard path (the counterpart of ``engine_jax``'s
    ``resolve_sweep_mesh``).  ``devices``: None, 0 or 1 (one shard), a
    number of shards, or ``"all"`` (the world size)."""
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    if devices == "all":
        n = 1 if group is None else dist.get_world_size(group)
    elif devices is None or (isinstance(devices, int)
                             and not isinstance(devices, bool)
                             and devices >= 0):
        n = devices or 1
    else:
        raise ValueError(f"devices must be None, a number of shards or "
                         f"'all', got {devices!r}")
    return None if n == 1 else place(n, group)


def as_group(shards) -> ShardGroup:
    """A :class:`ShardGroup`, or an int P (one process, every block)."""
    return shards if isinstance(shards, ShardGroup) else ShardGroup(
        int(shards))


def even_shards(k: int, n_shards: int | None) -> int | None:
    """K/P when ``n_shards`` splits the K clients evenly (the block size of
    :func:`shard_leading`), else None.  None or 1 shard means no sharding
    (None), as one device does in the JAX package."""
    if n_shards in (None, 0, 1):
        return None
    return k // n_shards if k % n_shards == 0 else None


def shard_leading(x: torch.Tensor, n_shards: int, dim: int = 0):
    """The ``n_shards`` contiguous client blocks of ``x`` along its client
    axis ``dim``: [..., K, ...] -> [..., P, K/P, ...], a view."""
    return x.unflatten(dim, (n_shards, -1))


def pad_leading(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Edge-pad the leading axis up to a multiple of ``multiple`` (the last
    row repeated); the caller cuts the padded tail off the result."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def grid_rows(n_rows: int, sg: ShardGroup, device=None) -> torch.Tensor:
    """This rank's rows of a grid of ``n_rows`` points padded to a multiple
    of R (a rank runs its P/R blocks in one call, so padding to P would
    only add rows): indices into [0, n_rows), the padded tail repeating
    the last."""
    rows = pad_leading(torch.arange(n_rows, device=device), sg.world)
    per = rows.shape[0] // sg.world
    return rows[sg.rank * per:(sg.rank + 1) * per]


def _check_backend(x: torch.Tensor, group) -> None:
    backend = dist.get_backend(group)
    if (backend == "nccl") != x.is_cuda:
        raise ValueError(f"a {backend} collective got a tensor on "
                         f"{x.device}: NCCL takes CUDA tensors and gloo CPU "
                         f"ones")


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` in place (no-op for None);
    counted in ``collective_counts`` (below) when it runs."""
    if group is not None:
        _check_backend(x, group)
        dist.all_reduce(x, op=op, group=group)
        _count("all_reduce_max" if op == dist.ReduceOp.MAX else "all_reduce",
               x)
    return x


def sum_shards(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The cross-shard sum over the block axis ``dim`` (``psum``), in
    ``x``'s dtype: this rank's blocks summed, then over the ranks."""
    return all_reduce(x.sum(dim, dtype=x.dtype), group)


def gather_shards(x: torch.Tensor, dim: int = 1, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``all_gather``): the block axis [..., P/R, ...] -> [..., P, ...], or a
    grid's rows.  On one process (``group`` None) ``x`` already holds them
    all.  Every rank's ``x`` has the same shape.  Counted in
    ``collective_counts`` (below)."""
    if group is None:
        return x
    x = x.contiguous()
    _check_backend(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _count("all_gather", out)
    return out


def shard_state(state: BanditState, n_shards: int) -> BanditState:
    """[G, K'] state -> the sharded [G*P', K'/P'] state of its P' blocks
    (views of the same memory; the counters repeated over the block
    rows)."""
    g = state.n_sel.shape[0]
    leaves = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        leaves[f.name] = (x.repeat_interleave(n_shards) if x.dim() == 1
                          else x.reshape(g * n_shards, -1, *x.shape[2:]))
    return BanditState(**leaves)


def unshard_state(state: BanditState, n_shards: int) -> BanditState:
    """The inverse of :func:`shard_state`: [G*P', K'/P'] -> [G, K'], the
    counters from block 0 (all blocks hold the same)."""
    gp = state.n_sel.shape[0]
    g = gp // n_shards
    leaves = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        leaves[f.name] = (x.view(g, n_shards)[:, 0].contiguous()
                          if x.dim() == 1
                          else x.reshape(g, -1, *x.shape[2:]))
    return BanditState(**leaves)


def bandit_state_bytes(k: int, n_shards: int = 1) -> int:
    """Bytes of bandit state one shard holds for one grid point at K
    clients over ``n_shards`` blocks: the per-client leaves split K/P per
    shard, the scalar counters replicate.  Computed from the fields of
    :class:`~repro_torch.core.bandit.BanditState` (on the meta device, no
    allocation)."""
    state = BanditState.create(1, k, device="meta")
    total = 0
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        nbytes = x.numel() * x.element_size()
        total += nbytes if x.dim() == 1 else -(-nbytes // n_shards)
    return total


# ---------------------------------------------------------------------------
# The model half: the PartitionSpec rules of every model family and the
# collectives the model-parallel LMs run (models/layers.py).
# ---------------------------------------------------------------------------
#
# A spec (:class:`Spec`) is a tuple with one entry per dim of a leaf: None
# (whole), a mesh axis name, or a tuple of names; () is "replicated" (JAX's
# ``P()``).  The rules, matched against the leaf's path ("layers/attn/wq"),
# are applied from the right (trailing dims), so stacked leading layer or
# group dims stay whole, and every axis is kept only where it divides its
# dim evenly (seamless-m4t's vocab 256206 stays whole on 16 ranks).  ``fsdp`` also
# splits one non-TP weight dim over ``data`` (ZeRO-3 style).  TP choices
# (Megatron): column-parallel wq/wk/wv and w_gate/w_up (last dim over
# ``model``), row-parallel wo/w_down (second-last dim), experts' E over
# ``model``, the vocab of embed/unembed over ``model``, norms replicated;
# dense KV caches hold batch over the data axes and the *sequence* over
# ``model`` (split-KV decoding).  A mesh is given by its axis sizes, a dict
# {name: size} in mesh order (:func:`axis_sizes`), so the rules need no
# process group.

class Spec(tuple):
    """One leaf's spec: a tuple (equal to the JAX ``PartitionSpec`` of the
    same entries), a leaf of spec trees whose nodes may be tuples too."""


def axis_sizes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or of such a
    dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def cohort_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that enumerate FL cohorts in the pod runtime: ``pod``
    (when present) and ``data``."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch is split over (``pod`` included when
    present)."""
    return cohort_axes(mesh)


def _batch_entry(sizes: dict):
    """The batch axes as one spec entry, a lone name unwrapped as
    ``PartitionSpec`` stores it."""
    ba = batch_axes(sizes)
    return ba[0] if len(ba) == 1 else ba


def _path(keys) -> str:
    return "/".join(str(k) for k in keys)


def map_with_path(fn, tree, keys=()):
    """``fn(path, leaf)`` over the leaves of a tree of dicts, tuples and
    lists, the path joined by "/" as the JAX package flattens it."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(map_with_path(fn, v, keys + (i,))
                          for i, v in enumerate(tree))
    return fn(_path(keys), tree)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in its order."""
    out = []
    map_with_path(lambda _, x: out.append(x), tree)
    return out


def axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _guarded(spec: tuple, shape: tuple, sizes: dict) -> Spec:
    """Drop any axis that does not evenly divide its dim."""
    return Spec(axis if axis is not None and dim > 1
                 and dim % axis_size(sizes, axis) == 0 else None
                 for dim, axis in zip(shape, spec))


def _from_right(right: tuple, ndim: int) -> tuple:
    right = tuple(right)
    if ndim < len(right):
        right = right[-ndim:]
    return (None,) * (ndim - len(right)) + right


# rules: (regex on path, spec-from-right). First match wins.
def _param_rules(fsdp: bool) -> list[tuple[str, tuple | None]]:
    d = "data" if fsdp else None
    return [
        # --- MoE experts: [.., E, D, F] / [.., E, F, D]
        (r"moe/shared/w_(gate|up)$", (d, "model")),
        (r"moe/shared/w_down$", ("model", d)),
        (r"moe/.*w_(gate|up)$", ("model", d, None)),
        (r"moe/.*w_down$", ("model", None, d)),
        (r"moe/router$", (None, None)),
        # --- xlstm (before generic attn/mlp rules)
        (r"mlstm/.*w_if$", (None, None)),
        (r"mlstm/.*w_[qk]$", (d, None)),
        (r"mlstm/.*w_v$", (d, "model")),
        (r"slstm", None),              # replicated (tiny, sequential cell)
        # --- attention
        (r"(attn|self_attn|cross_attn)/wq$", (d, "model")),
        (r"wkv$", (d, "model")),
        (r"(attn|self_attn|cross_attn)/w[kv]$", (d, "model")),
        (r"(attn|self_attn|cross_attn)/wo$", ("model", d)),
        (r"[qk]_norm$", (None,)),
        # --- gated MLPs (dense mlp, mlstm up/gate, griffin w_gate)
        (r"w_(gate|up)$", (d, "model")),
        (r"w_down$", ("model", d)),
        # --- embeddings
        (r"embed/tok$", ("model", None)),
        (r"unembed$", (None, "model")),
        (r"patch_proj$", (None, "model")),
        # --- griffin recurrent block
        (r"w_x$", (d, "model")),
        (r"w_[ri]$", (None, "model")),
        (r"lam$", ("model",)),
        (r"w_out$", ("model", d)),
        (r"conv$", (None, "model")),
        (r"w_in$", (d, None)),
        # --- norms and anything else
        (r"(norm|bias|scale)", None),
    ]


def spec_for_leaf(path_s: str, shape: tuple, rules, mesh) -> Spec:
    """Resolve one param leaf (flattened ``path_s``, ``shape``) against the
    rule table: first regex match wins, the spec is applied from the right
    and divisibility-guarded; no match => replicated."""
    sizes = axis_sizes(mesh)
    for pat, right in rules:
        if re.search(pat, path_s):
            if right is None:
                return Spec()
            return _guarded(_from_right(right, len(shape)), shape, sizes)
    return Spec()      # default: replicated (safe)


def param_specs(param_shapes, cfg, mesh, fsdp: bool = False):
    """Spec tree of a model's parameters (any tree of leaves with
    ``.shape``: the ``meta`` tree of ``ModelApi.param_shapes`` or real
    tensors), mirroring it.  ``cfg`` is unused, as in the JAX package."""
    rules = _param_rules(fsdp)
    return map_with_path(
        lambda p, x: spec_for_leaf(p, tuple(x.shape), rules, mesh),
        param_shapes)


def cache_specs(cache_shapes, cfg, mesh):
    """Decode caches and recurrent states: dense KV caches [L, B, S, KV,
    dh] batch over the data axes and sequence over ``model``; griffin's
    ring caches [B, Wnd, KV, dh] the window over ``model``; an enc-dec's
    ``enc_out`` batch only; the mLSTM's C and n their last dim over
    ``model``; any other state its last dim when that is >= 16."""
    sizes = axis_sizes(mesh)
    ba = _batch_entry(sizes)

    def leaf(s, x):
        nd = len(x.shape)
        shape = tuple(x.shape)
        if re.search(r"(^|/)(k|v)$", s) and nd == 5:      # [L,B,S,KV,dh]
            return _guarded((None, ba, "model", None, None), shape, sizes)
        if re.search(r"(^|/)(k|v)$", s) and nd == 4:      # [B,Wnd,KV,dh]
            return _guarded((ba, "model", None, None), shape, sizes)
        if s.endswith("enc_out"):                          # [B,S,D]
            return _guarded((ba, None, None), shape, sizes)
        if "mlstm" in s and nd == 6:                       # C [G,7,B,H,dh,dh]
            return _guarded((None, None, ba, None, None, "model"), shape,
                            sizes)
        if "mlstm" in s and nd == 5:                       # n / conv_buf
            return _guarded((None, None, ba, None, "model"), shape, sizes)
        spec = [None] * nd
        if nd >= 2 and shape[-1] >= 16:
            spec[-1] = "model"
        return _guarded(tuple(spec), shape, sizes)

    return map_with_path(leaf, cache_shapes)


def batch_specs(input_shapes, mesh):
    """Input-batch specs: the leading (batch) dim over the data/pod axes,
    everything else whole."""
    sizes = axis_sizes(mesh)
    ba = _batch_entry(sizes)
    return map_with_path(
        lambda _, x: _guarded((ba,) + (None,) * (len(x.shape) - 1),
                              tuple(x.shape), sizes), input_shapes)


def opt_specs(opt_shapes: dict, pspecs):
    """Optimizer state: the moments (``m``, ``v``, ``mu``) take the
    parameters' specs; the step counter and anything else replicate."""
    out = {}
    for k, v in opt_shapes.items():
        if k in ("m", "v", "mu"):
            out[k] = map_with_path(lambda _, s: s, pspecs)
        else:
            out[k] = map_with_path(lambda _, x: Spec(), v)
    return out


def local_shape(shape, spec: tuple, sizes: dict) -> tuple:
    """One rank's block of a leaf of ``shape`` under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // axis_size(sizes, a) for d, a in zip(shape, spec))


def local_bytes(shapes, specs, sizes: dict) -> int:
    """Bytes of one rank's blocks of every leaf of ``shapes`` (leaves with
    ``.shape`` and ``.dtype``) under the mirroring ``specs``."""
    total = 0

    def add(path, x):
        nonlocal total
        spec = spec_at(specs, path)
        total += math.prod(local_shape(tuple(x.shape), spec, sizes)) \
            * x.dtype.itemsize
    map_with_path(add, shapes)
    return total


def spec_at(specs, path: str) -> Spec:
    """The spec of the leaf at ``path`` ("a/b/0") of a spec tree."""
    node = specs
    for k in path.split("/") if path else ():
        node = node[int(k) if isinstance(node, (tuple, list)) else k]
    return node


def mesh_coords(mesh) -> dict:
    """{axis name: this rank's index along it} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def block_index(axis, coords: dict, sizes: dict) -> int:
    """This rank's block along ``axis`` (a name or a tuple of names, the
    first outermost, as a ``NamedSharding`` lays them out)."""
    names = axis if isinstance(axis, (tuple, list)) else (axis,)
    idx = 0
    for a in names:
        idx = idx * sizes[a] + coords[a]
    return idx


def shard_leaf(x: torch.Tensor, spec: tuple, coords: dict,
               sizes: dict) -> torch.Tensor:
    """This rank's contiguous block of ``x`` under ``spec``: along each
    split dim, block ``block_index`` of ``axis_size`` equal ones (a view
    where nothing is split)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(sizes, axis)
        size = x.shape[dim] // n
        x = x.narrow(dim, block_index(axis, coords, sizes) * size, size)
    return x.contiguous()


def block_keeper(specs, sizes: dict, coords: dict):
    """``keep(path, tree, lead=0)`` for a model's ``init``: the rank at
    ``coords`` of a mesh of ``sizes`` keeps its blocks (:func:`shard_leaf`)
    of ``tree``, the subtree at ``path`` ("a/b") of the parameter tree
    whose spec tree is ``specs``.  With ``lead`` > 0, ``tree`` is one draw
    of leaves stacked on that many leading dims ([L]: one layer), cut by
    their specs less those dims, which no rule splits.  An ``init`` that
    calls it on each subtree as it is drawn holds this rank's share of the
    model and one draw whole, never the whole model."""
    def keep(path, tree, lead: int = 0):
        sub = spec_at(specs, path)

        def cut(p, x):
            spec = tuple(spec_at(sub, p))
            if any(a is not None for a in spec[:lead]):
                raise ValueError(f"{path}/{p}: a stacked dim is split "
                                 f"({spec})")
            return shard_leaf(x, spec[lead:], coords, sizes)
        return map_with_path(cut, tree)
    return keep


def shard_params(params, specs, mesh):
    """Each leaf of ``params`` cut to this rank's block of the
    ``DeviceMesh`` ``mesh`` under the mirroring ``specs`` (``torch.chunk``
    along each split dim, the blocks in mesh order as a ``NamedSharding``
    lays them out)."""
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    return map_with_path(
        lambda p, x: shard_leaf(x, spec_at(specs, p), coords, sizes), params)


# The collectives of the model-parallel LMs.  Each counts its calls and
# bytes (all_reduce: the tensor's; all_gather: the gathered result's, the
# JAX package's result-shape convention; reduce_scatter: the summed input's)
# while it runs, in the forward and in the backward pass alike, for the dry
# run and chip_smoke.py to read.

collective_counts = {kind: {"calls": 0, "bytes": 0}
                     for kind in ("all_reduce", "all_reduce_max",
                                  "all_gather", "reduce_scatter")}


def reset_collective_counts() -> None:
    for c in collective_counts.values():
        c["calls"] = c["bytes"] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    collective_counts[kind]["calls"] += 1
    collective_counts[kind]["bytes"] += x.numel() * x.element_size()


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` replaced in place by its elementwise max over the ranks of
    ``group`` (no-op for None)."""
    return all_reduce(x, group, op=dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a new
    contiguous tensor, laid out as one process would hold it; ``x`` itself
    for ``group`` None)."""
    if group is None:
        return x
    _check_backend(x, group)
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    # torch 2.13 names it all_gather_single and deprecates the older name,
    # which earlier versions alone have
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, xt, group=group)
    _count("all_gather", out)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# The collectives under autograd: the conjugate pairs of tensor parallelism
# (the table in the module docstring says which call site takes which).
# Each is out of place and counted in ``collective_counts`` in the forward
# and in the backward pass.  With no gradient to track (serving, or a group
# of None) each is the plain collective above.
# ---------------------------------------------------------------------------

def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``group`` of every rank's ``x``, cut along
    ``dim`` into as many equal blocks as ranks: this rank's block (a new
    contiguous tensor)."""
    _check_backend(x, group)
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    # torch 2.13 names it reduce_scatter_single, as all_gather above
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, xt, group=group)
    _count("reduce_scatter", xt)
    return out.movedim(0, dim).contiguous()


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(x.clone(memory_format=torch.contiguous_format), group)


class SumPartials(torch.autograd.Function):
    """Forward: the ranks' partial results summed (``all_reduce``).
    Backward: the identity, since what follows is the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToParallel(torch.autograd.Function):
    """Forward: the identity, where a tensor the same on every rank meets
    work split over the ranks.  Backward: the ranks' partial gradients
    summed (``all_reduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim % x.dim(), group, x.shape[dim]
        return all_gather(x, dim, group)


class GatherReplicated(_Gather):
    """Forward: ``all_gather`` along ``dim``.  Backward: this rank's slice
    of the gradient, since every rank does the same work with the gathered
    tensor."""

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None


class GatherSplit(_Gather):
    """Forward: ``all_gather`` along ``dim``.  Backward: a reduce-scatter
    (the ranks' gradients summed, then this rank's slice), since each rank
    uses the gathered tensor on its own share of the work."""

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`SumPartials` of ``x`` (``x`` itself for ``group`` None).
    With no gradient tracked the sum runs in place: pass a tensor the
    caller does not read again."""
    if group is None:
        return x
    if not _tracked(x):
        return all_reduce(x, group)
    return SumPartials.apply(x, group)


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`CopyToParallel` of ``x`` (``x`` itself for ``group`` None or
    with no gradient tracked)."""
    if group is None or not _tracked(x):
        return x
    return CopyToParallel.apply(x, group)


def gather(x: torch.Tensor, dim: int, group, split: bool = False
           ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``: :class:`GatherSplit`
    when each rank uses the result on its own share of the work
    (``split``), else :class:`GatherReplicated`; the plain
    :func:`all_gather` with no gradient tracked."""
    if group is None:
        return x
    if not _tracked(x):
        return all_gather(x, dim, group)
    return (GatherSplit if split else GatherReplicated).apply(x, dim, group)
