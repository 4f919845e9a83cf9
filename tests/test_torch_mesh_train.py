"""Training over a (data, model) mesh of gloo ranks on the CPU: the
collectives' autograd Functions (distributed/sharding.py), the sharded
AdamW step (launch/steps.make_train_step with ``mp``), the cohort FL round
with a model axis against the JAX package's ``make_fl_round`` on the same
mesh, and the dry run's train and FL-round cells.

One spawn of 2 ranks and one of 4 (tests/_torch_dist.py, one torch thread a
rank) run every rank-side check; the JAX round and the dry run each run in
a child process started before the spawns, so they overlap them.

1. The four Functions on 2 and 4 ranks against autograd of the same
   arithmetic in one process, in float64 on integer-valued inputs, so
   every sum is exact in any order and the test holds them equal: sum of
   partials (forward all_reduce, backward identity), copy into a parallel
   region (identity, all_reduce of the gradient), gather for replicated use
   (all_gather, this rank's slice) and for split use (all_gather,
   reduce-scatter), along dims 0 and 1.  Each output's ``grad_fn`` is its
   Function's, each direction issues the collectives its rule names, and
   with no gradient tracked each gives the same values.

2. One AdamW step (lr 3e-4, weight decay 0.1), then a second loss, of the
   reduced smollm-135m and qwen3-1.7b (dense), phi3.5-moe (moe),
   llava-next-34b (vlm, at S = 1024 with ``shard_attn_batch``: the
   context-parallel route), recurrentgemma-9b (griffin), xlstm-1.3b and
   seamless-m4t-medium (encdec), float32, on meshes 1 x 2 and 2 x 1 (2
   ranks) and 2 x 2 (4 ranks), the dense family with FSDP too and qwen3
   with remat on 2 x 2, each against the one-process step on the same
   parameters and batches:
     * the losses within rtol 1e-5 (read: 2.2e-7);
     * every rank's block of every gradient, and of both AdamW moments
       after the step, within 1e-5 of the leaf's largest entry (read:
       2.0e-6 and 2.4e-6);
     * the updated block bitwise the one-process AdamW update of that
       block from this rank's gradient (the optimizer is elementwise);
     * the updated parameters within rtol / atol 1e-5 of the one-process
       step wherever the one-process gradient is at least 1e-6 in
       magnitude.  AdamW's first step moves an entry by lr * g / (|g| +
       eps) (eps 1e-8): where |g| is within a few eps of 0, a gradient
       difference of 1e-8 (1e-6 of a leaf's largest) moves the update by
       a good part of lr; there the test holds |difference| <= 2 lr, the
       update's range (read: 4.9e-5 at most over all entries, below 1e-6
       where |g| >= 1e-6).
   The collective calls follow the routes: FSDP's gathers reduce-scatter
   in the backward, the context-parallel route's four gathered weights a
   layer too.  Remat recomputes a layer in the backward only as far as its
   last tensor the backward reads (non-reentrant ``torch.utils.checkpoint``
   stops there): the attention's row-parallel sum runs again, the MLP's,
   whose output only the residual add reads, does not.

3. ``make_fl_round(..., mesh, stacked_specs)`` on a (2, 2) mesh of 4
   ranks against JAX's on a (2, 2) mesh of 4 XLA host devices (one child
   process whose ``env=`` alone carries the device-count flag and
   single-threaded XLA): reduced smollm-135m in float32 from JAX's init
   (``convert.lm_params_from_tree``), 2 SGD steps (lr 0.1) of 4 x 16
   tokens a cohort, weights (1, 0), top-k ratio 0.05, every compress mode,
   each rank's block of the new global model against the same block of
   JAX's:
     * ``none`` within 1e-5 of the leaf's largest entry;
     * ``int8`` and ``int8_psum`` within one quantization step of the
       block's scale per entry: with weights (1, 0) the aggregated delta
       is cohort 0's codes times its scale, whose largest code is +-127,
       so the scale is the block's largest |delta| / 127;
     * ``topk``: the kept entries (the delta's non-zeros) of each block
       the same sets, values within 1e-5 of the leaf's largest entry.
       Both packages break an exact tie at the k-th magnitude toward the
       lower index (``core/bandit.top_k``, ``lax.top_k``); a kept entry
       of one side only is allowed where its magnitude lies within 1e-5
       of the block's k-th largest (a near tie that float32 rounding of
       the local steps can reorder) (read: none);
     * the mean loss within rtol 1e-5.

4. The dry run: ``--fl-round smollm-135m --reduced --mesh 2x2`` in every
   compress mode, its bytes a rank equal to ``local_bytes`` of the stacked
   specs; reduced train cells on a fake 2 x 4 mesh run loss, backward and
   update (``"flops_of": "train"``).  recurrentgemma-9b's train FLOPs lie
   between 2.5 and 3.5 times its forward's (forward, and a backward of
   about twice its work); smollm-135m's between 3 and 4 times, since the
   attention Function's backward recomputes the attention forward
   (kernels/ops.FlashAttentionFn, as the JAX package's) and attention
   leads a reduced model's work at S = 4096.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist import mesh_checks, run_ranks  # noqa: E402

from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import fl_parallel, sharding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

SEED = 27
ARCHS = ("smollm-135m", "qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
         "llava-next-34b", "recurrentgemma-9b", "xlstm-1.3b",
         "seamless-m4t-medium")
FSDP = ("smollm-135m", "qwen3-1.7b")              # the dense family
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
LR, EPS, TOL = 3e-4, 1e-8, 1e-5
FL_STEPS, FL_BATCH, FL_SEQ, FL_LR, FL_RATIO = 2, 4, 16, 0.1, 0.05
FL_WEIGHTS = np.array([1.0, 0.0], np.float32)
SRC = str(Path(__file__).resolve().parents[1] / "src")
MODES = fl_parallel.COMPRESS


def _env(tmp) -> dict:
    """A child's environment: the source path, a home of its own, torch on
    one thread and JAX on 4 single-threaded host devices."""
    return {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin:/usr/local/bin",
            "HOME": str(tmp), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1"}


JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed import fl_parallel, sharding
from repro.models import transformer
from repro.models.registry import build
from repro.optim.sgd import OptimizerConfig

assert jax.device_count() == 4
inp = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = dataclasses.replace(build("smollm-135m", reduced=True).cfg,
                          compute_dtype=jnp.float32)
params = {}
for k in inp.files:
    if k.startswith("params:"):
        node = params
        *head, leaf = k[len("params:"):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(inp[k])
pspecs = sharding.param_specs(params, cfg, mesh, fsdp=False)
sspecs = fl_parallel.stacked_param_specs(pspecs, mesh)
opt = OptimizerConfig(name="sgd", lr=float(inp["lr"]), lr_decay=0.0).build()
c = inp["weights"].shape[0]
opt_state = jax.vmap(opt.init)(fl_parallel.stack_for_cohorts(params, c))
batches = {"tokens": jnp.asarray(inp["tokens"])}
weights = jnp.asarray(inp["weights"])
loss_fn = lambda p, b: transformer.loss_fn(p, b, cfg)
out = {}
for mode in ["none", "int8", "int8_psum", "topk"]:
    fl_round = fl_parallel.make_fl_round(
        loss_fn, opt, int(inp["steps"]), mesh, sspecs, compress=mode,
        topk_ratio=float(inp["ratio"]))
    new, _, loss = jax.jit(fl_round)(params, opt_state, batches, weights)
    for p, x in jax.tree_util.tree_flatten_with_path(new)[0]:
        out[mode + ":" + sharding._path_str(p)] = np.asarray(x)
    out["loss_" + mode] = np.float32(loss)
np.savez(sys.argv[2], **out)
"""

DRYRUN_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
res = dryrun.main(["--fl-round", "smollm-135m", "--reduced", "--mesh", "2x2",
                   "--out", sys.argv[1]]
                  + [a for m in json.loads(sys.argv[2])
                     for a in ("--compress", m)])
for arch in ("smollm-135m", "recurrentgemma-9b"):
    res[arch] = dryrun.run_cell(arch, "train_4k", {"data": 2, "model": 4},
                                reduced=True)
print(json.dumps(res))
"""


def _flat(tree) -> dict:
    out = {}
    sharding.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = x
    return tree


def _train_case(arch: str, mesh, fsdp=False, remat=False) -> dict:
    api = registry.build(arch, reduced=True)
    rng = np.random.default_rng(SEED)
    seq, b = (1024, 2) if api.cfg.family == "vlm" else (32, 4)
    batches = []
    for _ in range(2):
        x = serve.make_batch(api, rng, b, seq)
        batches.append({k: v.float().numpy() if v.is_floating_point()
                        else v.numpy() for k, v in x.items()})
    return dict(arch=arch, mesh=mesh, fsdp=fsdp, remat=remat,
                batches=batches)


def _train_cases(world: int) -> dict:
    out = {}
    for mesh in MESHES[world]:
        for arch in ARCHS:
            for fsdp in (False, True) if arch in FSDP else (False,):
                c = _train_case(arch, mesh, fsdp)
                c["reference"] = mesh == (1, 2) and not fsdp
                out[f"{arch}|{mesh[0]}x{mesh[1]}|fsdp={fsdp}"] = c
    if world == 4:
        c = _train_case("qwen3-1.7b", (2, 2), remat=True)
        c["reference"] = True
        out["qwen3-1.7b|2x2|remat"] = c
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's rounds, "dryrun": the dry run's records, 2 and 4:
    (train cases, every rank's results)}.  The children start first and
    run while the ranks do."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg = jbuild("smollm-135m", reduced=True).cfg
    params = jax.tree.map(np.asarray, jtransformer.init(
        jax.random.PRNGKey(0), cfg))
    flat = {"params:" + p: x for p, x in _flat(params).items()}
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FL_WEIGHTS.shape[0], FL_STEPS, FL_BATCH, FL_SEQ)
    ).astype(np.int32)
    np.savez(tmp / "in.npz", tokens=toks, weights=FL_WEIGHTS, lr=FL_LR,
             ratio=FL_RATIO, steps=FL_STEPS, **flat)
    children = {
        "jax": subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
             str(tmp / "out.npz")], env=_env(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "dryrun": subprocess.Popen(
            [sys.executable, "-c", DRYRUN_SCRIPT, str(tmp / "dryrun.json"),
             json.dumps(list(MODES))], env=_env(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    try:
        out = {}
        fl = (params, {"tokens": toks}, FL_WEIGHTS, FL_STEPS, FL_LR,
              FL_RATIO)
        for world in (2, 4):
            cases = _train_cases(world)
            out[world] = cases, run_ranks(
                mesh_checks, world, tmp, SEED, cases,
                fl if world == 4 else None, timeout=600)
        for name, proc in children.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, (name, stderr[-3000:])
            out[name] = stdout
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    jx = dict(np.load(tmp / "out.npz"))
    out["jax"] = {m: (_flat(convert.lm_params_from_tree(_nest(
        {k[len(m) + 1:]: v for k, v in jx.items()
         if k.startswith(m + ":")}))), float(jx["loss_" + m]))
        for m in MODES}
    out["fl_params"] = params
    out["dryrun"] = json.loads(out["dryrun"].strip().splitlines()[-1])
    return out


# ---------------------------------------------------------------------------
# 1. the Functions
# ---------------------------------------------------------------------------

FUNCTIONS = {
    # name: (grad_fn, forward calls, backward calls)
    "sum_partials": ("SumPartialsBackward", {"all_reduce": 1}, {}),
    "copy_to_parallel": ("CopyToParallelBackward", {}, {"all_reduce": 1}),
    "gather_replicated": ("GatherReplicatedBackward", {"all_gather": 1}, {}),
    "gather_split": ("GatherSplitBackward", {"all_gather": 1},
                     {"reduce_scatter": 1}),
    "gather_split_rows": ("GatherSplitBackward", {"all_gather": 1},
                          {"reduce_scatter": 1}),
}


def _one_process(name: str, world: int):
    """[(output, input gradient)] of every rank, by autograd in one
    process over the same draws as ``_torch_dist.collective_functions``."""
    rng = np.random.default_rng(SEED)
    xs = torch.tensor(rng.integers(-8, 9, (world, 3, 4)).astype(np.float64),
                      requires_grad=True)
    cs = torch.tensor(rng.integers(-8, 9, (world, 3, 4 * world)).astype(
        np.float64))
    if name == "sum_partials":
        y = xs.sum(0)
        ys = [y] * world
        loss = (y * cs[0, :, :4]).sum()
    elif name == "copy_to_parallel":
        ys = [xs[0]] * world
        loss = sum((xs[0] * cs[r, :, :4]).sum() for r in range(world))
    elif name == "gather_replicated":
        y = torch.cat(list(xs), 1)
        ys = [y] * world
        loss = (y * cs[0]).sum()
    elif name == "gather_split":
        y = torch.cat(list(xs), 1)
        ys = [y] * world
        loss = sum((y * cs[r]).sum() for r in range(world))
    else:
        y = torch.cat(list(xs), 0)
        ys = [y] * world
        loss = sum((y * cs[r].reshape(3 * world, 4)).sum()
                   for r in range(world))
    loss.backward()
    grads = xs.grad
    if name == "copy_to_parallel":           # every rank holds xs[0]
        grads = grads[:1].expand(world, 3, 4)
    return [(ys[r].detach().numpy(), grads[r].numpy())
            for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_collective_functions_match_one_process(runs, name, world):
    _, res = runs[world]
    grad_fn, fwd, bwd = FUNCTIONS[name]
    zero = {k: 0 for k in sharding.collective_counts}
    for rank, (y, grad) in enumerate(_one_process(name, world)):
        got = res[rank]["functions"][name]
        assert np.array_equal(got["y"], y), (name, rank)
        assert np.array_equal(got["grad"], grad), (name, rank)
        assert np.array_equal(got["no_grad"], y), (name, rank)
        assert got["grad_fn"] == grad_fn
        assert got["forward_calls"] == {**zero, **fwd}
        assert got["backward_calls"] == {**zero, **bwd}


# ---------------------------------------------------------------------------
# 2. the sharded AdamW step
# ---------------------------------------------------------------------------

def _block(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    return sharding.shard_leaf(torch.as_tensor(x), spec, coords,
                               sizes).numpy()


def _leaf_close(got, want, scale, where):
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * max(scale, 1e-30), f"{where}: {err:.3g}"


def _reference(runs, case: dict) -> dict:
    for world in (2, 4):
        cases, res = runs[world]
        for name, c in cases.items():
            if (c["reference"] and c["arch"] == case["arch"]
                    and c["remat"] == case["remat"]):
                return res[0]["train"][name + ":reference"]
    raise KeyError(case["arch"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_process(runs, world, arch):
    cases, res = runs[world]
    cfg = registry.build(arch, reduced=True).cfg
    for name, case in cases.items():
        if case["arch"] != arch:
            continue
        want = _reference(runs, case)
        sizes = {"data": case["mesh"][0], "model": case["mesh"][1]}
        specs = _flat(sharding.param_specs(
            registry.build(arch, reduced=True).param_shapes(), cfg, sizes,
            fsdp=case["fsdp"]))
        for rank, out in enumerate(res):
            got = out["train"][name]
            where = f"{name} rank {rank}"
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=TOL, err_msg=where)
            assert got["own_update"], where
            for p, spec in specs.items():
                at = (spec, got["coords"], sizes)
                g_ref = _block(want["grads"][p], *at)
                _leaf_close(got["grads"][p], g_ref,
                            np.abs(want["grads"][p]).max(), f"{where} {p}")
                for key in ("m", "v"):
                    ref = want["first"][key][p]
                    _leaf_close(got["first"][key][p], _block(ref, *at),
                                np.abs(ref).max(), f"{where} {key} {p}")
                p_ref = _block(want["first"]["params"][p], *at)
                diff = np.abs(got["first"]["params"][p] - p_ref)
                sure = np.abs(g_ref) >= 1e-6
                assert (diff[sure] <= TOL + TOL * np.abs(p_ref[sure])).all(
                ), f"{where} params {p}: {diff[sure].max():.3g}"
                assert diff.max() <= 2 * LR, f"{where} params {p}"


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_train_collectives_follow_the_routes(runs, world):
    cases, res = runs[world]
    for name, case in cases.items():
        counts = res[0]["train"][name]["counts"]
        data, model = case["mesh"]
        n_layers = registry.build(case["arch"], reduced=True).cfg.n_layers
        # FSDP's gathers over data reduce-scatter in the backward; so do
        # the context-parallel route's four gathered weights a layer (the
        # route runs at any model size that divides S)
        scatter = 4 * n_layers if case["arch"] == "llava-next-34b" else 0
        if case["fsdp"]:
            assert counts["reduce_scatter"] > 0, name
        else:
            assert counts["reduce_scatter"] == scatter, name
        if model > 1:
            assert counts["all_reduce"] > 0 and counts["all_gather"] > 0
    if world == 4:                # remat: the attention's row sum again
        plain = res[0]["train"]["qwen3-1.7b|2x2|fsdp=False"]["counts"]
        remat = res[0]["train"]["qwen3-1.7b|2x2|remat"]["counts"]
        assert remat == {**plain, "all_reduce": plain["all_reduce"] + 2}


# ---------------------------------------------------------------------------
# 3. the cohort round with a model axis against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_mesh_fl_round_matches_jax(runs, mode):
    want, want_loss = runs["jax"][mode]
    cfg = registry.build("smollm-135m", reduced=True).cfg
    base = _flat(convert.lm_params_from_tree(runs["fl_params"]))
    sizes = {"data": 2, "model": 2}
    specs = _flat(sharding.param_specs(base, cfg, sizes, fsdp=False))
    _, res = runs[4]
    for rank, out in enumerate(res):
        fl = out["fl"]
        got, loss = fl[mode]
        assert loss == pytest.approx(want_loss, rel=TOL)
        for p, spec in specs.items():
            where = f"{mode} {p} rank {rank}"
            at = (spec, fl["coords"], sizes)
            w, b = _block(want[p].numpy(), *at), _block(base[p].numpy(), *at)
            g = got[p]
            scale = np.abs(want[p].numpy()).max()
            if mode == "none":
                _leaf_close(g, w, scale, where)
                continue
            dw, dg = (w - b).astype(np.float64), (g - b).astype(np.float64)
            if mode in ("int8", "int8_psum"):
                step = np.abs(dw).max() / 127
                assert np.abs(dg - dw).max() <= step * (1 + 1e-3), where
                continue
            kept_w, kept_g = dw != 0, dg != 0
            k = int(kept_w.sum())
            assert k == max(1, int(dw.size * FL_RATIO)), where
            kth = np.sort(np.abs(dw[kept_w]))[0]
            odd = kept_w != kept_g
            assert (np.abs(np.where(kept_w, dw, dg)[odd] - kth)
                    <= TOL * kth).all(), where
            both = kept_w & kept_g
            _leaf_close(g[both], w[both], scale, where)


# ---------------------------------------------------------------------------
# 4. the dry run
# ---------------------------------------------------------------------------

def test_dryrun_fl_round_cells(runs):
    res = runs["dryrun"]
    api = registry.build("smollm-135m", reduced=True)
    sizes = {"data": 2, "model": 2}
    pshapes = api.param_shapes()
    sspecs = fl_parallel.stacked_param_specs(sharding.param_specs(
        pshapes, api.cfg, sizes, fsdp=False), sizes)
    stacked = sharding.map_with_path(
        lambda _, x: x.new_empty((2,) + x.shape), pshapes)
    mu = sharding.map_with_path(
        lambda _, x: x.new_empty(x.shape, dtype=torch.float32), stacked)
    opt = {"step": torch.empty((2,), dtype=torch.int32, device="meta"),
           "mu": mu}
    for mode in MODES:
        rec = res[f"fl-round-{mode}|smollm-135m|2x2|reduced"]
        assert rec["status"] == "ok", rec
        assert rec["param_bytes"] == sharding.local_bytes(stacked, sspecs,
                                                          sizes)
        assert rec["opt_bytes"] == sharding.local_bytes(
            opt, sharding.opt_specs(opt, sspecs), sizes)
        assert rec["flops"] > 0 and rec["flops_of"] == "fl_round"
        calls = {k: v["calls"] for k, v in rec["collectives"].items()}
        assert calls["all_reduce"] > 0
        if mode in ("int8", "topk"):          # the codes are gathered
            assert calls["all_gather"] > res[
                "fl-round-none|smollm-135m|2x2|reduced"]["collectives"][
                "all_gather"]["calls"]
        assert calls["all_reduce_max"] == int(mode == "int8_psum")


@pytest.mark.parametrize("arch, low, high", [
    ("recurrentgemma-9b", 2.5, 3.5), ("smollm-135m", 3.0, 4.0)])
def test_dryrun_train_cells_count_the_backward(runs, arch, low, high):
    rec = runs["dryrun"][arch]
    assert rec["status"] == "ok" and rec["flops_of"] == "train"
    assert low <= rec["flops"] / rec["forward_flops"] <= high
    assert rec["collectives"]["all_reduce"]["calls"] > 0
