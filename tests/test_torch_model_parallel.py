"""The LM families over a device mesh of gloo ranks on the CPU against one
process (models/layers.py's routes), and three of them against the JAX
package's own sharded runs.

Reduced smollm-135m, qwen3-1.7b, phi3.5-moe, llava-next-34b (with
``shard_attn_batch``, as its full config: at S = 1024 its prefill takes the
context-parallel route, each model rank attending with its q rows and
import _torch_dist  # noqa: E402


one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)
``q_offset``), recurrentgemma-9b, xlstm-1.3b and seamless-m4t-medium, each
in float32 and bfloat16 compute, on (data, model) meshes (1, 2) and
(2, 1) of 2 ranks and (2, 2) of 4, phi3.5-moe and llava with FSDP too.
Every rank draws the whole model from seed 0, keeps its blocks by
``param_specs`` and its batch rows by ``batch_specs``, then runs a prefill
and 3 decode steps fed the same tokens; rank 0 also runs the one-process
path (every rank process runs on one torch thread).  Against it:

  * float32 logits within rtol 1e-5 / atol 1e-5 (row-parallel sums and
    split-KV decoding add in other orders: read up to 4.5e-6), and the
    greedy picks equal;
  * bfloat16 logits at the family's gate of ``PERF.md`` §2 (chip_smoke.py's
    LM_TOL / FAMILY_TOL): dense rtol 2e-2 / atol 3e-2, moe and vlm 2e-2 /
    6e-2, enc-dec 2e-2 / 8e-2; griffin and xlstm gather every leaf and run
    the one-process code, bitwise (greedy picks are not compared in
    bfloat16: near ties);
  * the collectives of the prefill and of a decode step (calls by kind)
    as the routes predict (:func:`predicted`), in float32 without FSDP.

The JAX cases, each in float32 compute on a 2 x 2 mesh of 4 host devices,
its parameters from JAX's init sharded by JAX's ``param_specs``, its batch
by ``batch_specs``: reduced llava's prefill at S = 1024 through
``_context_parallel_flash`` (``shard_attn_batch``); reduced phi3.5-moe's
and qwen3's prefill, then 3 decode steps over the cache placed by JAX's
``cache_specs`` (the sequence over ``model``), fed the same tokens: the
experts over ``model`` with the capacity of the whole batch (4 tokens a
decode step, 2 slots an expert, so assignments drop) and split-KV
decoding, as GSPMD partitions them.  The port runs the same parameters on
4 gloo ranks: prefill and step logits within the float32 tolerance above.
JAX runs in one subprocess whose ``env=`` alone carries the 4-device
flag.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import _model_api, model_parallel, run_ranks  # noqa: E402

from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

ARCHS = ("smollm-135m", "qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
         "llava-next-34b", "recurrentgemma-9b", "xlstm-1.3b",
         "seamless-m4t-medium")
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
FSDP = ("phi3.5-moe-42b-a6.6b", "llava-next-34b")
BATCH, STEPS = 4, 3
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = {"dense": dict(rtol=2e-2, atol=3e-2),
            "moe": dict(rtol=2e-2, atol=6e-2),
            "vlm": dict(rtol=2e-2, atol=6e-2),
            "encdec": dict(rtol=2e-2, atol=8e-2),
            "griffin": dict(rtol=0, atol=0), "xlstm": dict(rtol=0, atol=0)}


def _prompt(arch: str) -> int:
    return 1024 if arch == "llava-next-34b" else 64


def _case(arch: str, dtype: str, mesh, fsdp: bool) -> dict:
    api = registry.build(arch, reduced=True)
    batch = serve.make_batch(api, np.random.default_rng(1), BATCH,
                             _prompt(arch))
    batch = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
             for k, v in batch.items()}
    seq = batch["tokens"].shape[1] + (api.cfg.n_patches
                                      if api.cfg.family == "vlm" else 0)
    feed = np.random.default_rng(2).integers(
        0, api.cfg.vocab, (BATCH, STEPS)).astype(np.int32)
    max_len = -(-(seq + STEPS) // 4) * 4          # splits over 1, 2, 4
    return dict(arch=arch, dtype=dtype, mesh=mesh, fsdp=fsdp, batch=batch,
                max_len=max_len, feed=feed)


def _cases(world: int) -> dict:
    out = {}
    for mesh in MESHES[world]:
        for arch in ARCHS:
            for dtype in ("float32", "bfloat16"):
                fsdps = (False, True) if arch in FSDP and dtype == "float32" \
                    else (False,)
                for fsdp in fsdps:
                    c = _case(arch, dtype, mesh, fsdp)
                    c["reference"] = mesh == MESHES[world][0] and not fsdp
                    out[f"{arch}|{dtype}|{mesh[0]}x{mesh[1]}|{fsdp}"] = c
    return out


# ---------------------------------------------------------------------------
# the collectives each route issues
# ---------------------------------------------------------------------------

def _attention(cfg, m: int, *, cache: bool, s: int, prefill: bool,
               cross: bool = False) -> dict:
    from repro_torch.models.layers import HEAD_DIMS, _flash_ok
    blockwise = s > 1 and _flash_ok(s, s)
    c = {"all_reduce": 0, "all_reduce_max": 0, "all_gather": 0,
         "reduce_scatter": 0}
    if (cfg.shard_attn_batch and prefill and blockwise and not cross
            and cfg.head_dim in HEAD_DIMS and s % m == 0):
        c["all_gather"] += 4 + 1          # the four weights, the output
        return c
    tp = cfg.n_kv_heads % m == 0
    c["all_gather"] += 0 if tp else 4
    if cache:
        c["all_gather"] += 2 if tp else 0   # every head's k, v
        if not blockwise:                   # split-KV over the cache
            c["all_gather"] += 1 if tp else 0
            c["all_reduce_max"] += 1
            c["all_reduce"] += 2
    c["all_reduce"] += 1 if tp else 0       # row-parallel wo
    return c


def _add(a: dict, b: dict, n: int = 1) -> dict:
    return {k: a[k] + n * b[k] for k in a}


def predicted(cfg, m: int, s: int) -> tuple[dict, dict]:
    """Collective calls of a prefill of S positions and of one decode step
    of a dense, moe, vlm or enc-dec model (no FSDP, a batch the data axis
    divides, every split dim divisible by m), by the routes of
    models/layers.py."""
    zero = {"all_reduce": 0, "all_reduce_max": 0, "all_gather": 0,
            "reduce_scatter": 0}
    head = dict(zero, all_reduce=1, all_gather=1)
    ffn = dict(zero, all_reduce=1)            # TP MLP
    if cfg.moe is not None:                   # routing, aux, experts
        ffn = dict(zero, all_reduce=2 + bool(cfg.moe.n_shared),
                   all_gather=1)
    out = []
    for prefill in (True, False):
        n = s if prefill else 1
        c = dict(head)
        if cfg.family == "vlm" and prefill:
            c["all_gather"] += 1              # patch_proj's columns
        layer = _add(_attention(cfg, m, cache=True, s=n, prefill=prefill),
                     ffn)
        if cfg.family == "encdec":
            layer = _add(layer, _attention(cfg, m, cache=False, s=n,
                                           prefill=prefill, cross=True))
            if prefill:
                enc = _add(_attention(cfg, m, cache=False, s=n,
                                      prefill=True, cross=True), ffn)
                c = _add(c, enc, cfg.n_enc_layers)
        out.append(_add(c, layer, cfg.n_layers))
    return out[0], out[1]


def predicted_gathers(cfg, mesh) -> dict:
    """Collective calls of any step of griffin or xlstm, which gathers every
    split leaf whole before use: one all-gather per split dim of each
    leaf, a stacked group's leaves once per group."""
    fam, _ = _model_api(cfg.name.replace("-reduced", ""), "float32")
    shapes = fam.init(registry._ShapeGenerator(), cfg)
    specs = sharding.param_specs(shapes, cfg, {"data": mesh[0],
                                               "model": mesh[1]})
    n = 0
    for key, sub in specs.items():
        leaves = []
        sharding.map_with_path(lambda _, x: leaves.append(x), shapes[key])
        groups = leaves[0].shape[0] if key in ("groups", "mlstm",
                                                "slstm") else 1
        n += groups * sum(sum(a is not None for a in spec)
                          for spec in sharding.spec_leaves(sub))
    return {"all_reduce": 0, "all_reduce_max": 0, "all_gather": n,
            "reduce_scatter": 0}


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

# the cases JAX also runs sharded on 2 x 2 host devices: llava's
# context-parallel prefill; phi3.5-moe's prefill and decode (expert-parallel,
# the capacity drop over the whole batch, split-KV decoding) and qwen3's
# (head-parallel, split-KV decoding)
JAX_CASES = {"llava-next-34b": 1, "phi3.5-moe-42b-a6.6b": STEPS + 1,
             "qwen3-1.7b": STEPS + 1}      # logits compared: prefill, steps


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's sharded runs of ``JAX_CASES`` in one child process: {arch:
    (case with the JAX parameters, [prefill logits, step logits...])}."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    cases = {}
    for i, arch in enumerate(JAX_CASES):
        case = _case(arch, "float32", (2, 2), False)
        np.savez(tmp / f"in{i}.npz", feed=case["feed"], **case["batch"])
        cases[arch] = case
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp)]
        + [f"{arch}={c['max_len']}={JAX_CASES[arch] - 1}"
           for arch, c in cases.items()],
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for i, (arch, case) in enumerate(cases.items()):
        res = dict(np.load(tmp / f"out{i}.npz"))
        params: dict = {}
        for path, x in res.items():
            if path.startswith("logits"):
                continue
            node = params
            *head, leaf = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = x
        case["params"] = params
        out[arch] = case, [res[f"logits{j}"] for j in range(JAX_CASES[arch])]
    return out


JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed import sharding
from repro.models import transformer
from repro.models.registry import build

assert jax.device_count() == 4
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
ctx = (jax.sharding.use_abstract_mesh(mesh.abstract_mesh)
       if hasattr(jax.sharding, "use_abstract_mesh") else mesh)


def put(tree, specs):
    return jax.device_put(tree, sharding.to_named(specs, mesh))


for i, arg in enumerate(sys.argv[2:]):
    arch, max_len, steps = arg.split("=")
    max_len, steps = int(max_len), int(steps)
    cfg = build(arch, reduced=True).cfg
    cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32,
                              shard_attn_batch=cfg.family == "vlm")
    data = np.load(f"{sys.argv[1]}/in{i}.npz")
    batch = {"tokens": jnp.asarray(data["tokens"])}
    if "patch_embeds" in data:
        batch["patch_embeds"] = jnp.asarray(data["patch_embeds"],
                                            jnp.bfloat16)
    params = transformer.init(jax.random.PRNGKey(0), cfg)
    sp = put(params, sharding.param_specs(params, cfg, mesh))
    sb = put(batch, sharding.batch_specs(batch, mesh))
    pre = jax.jit(lambda p, b: transformer.prefill(p, b, cfg,
                                                   max_len=max_len))
    dec = jax.jit(lambda p, c, t, pos: transformer.decode_step(p, c, t, pos,
                                                               cfg))
    with ctx:
        logits, cache, pos = pre(sp, sb)
        out = [np.asarray(logits)]
        cache = put(cache, sharding.cache_specs(cache, cfg, mesh))
        for step in range(steps):
            tok = jnp.asarray(data["feed"][:, step])
            tok = put(tok, sharding.batch_specs(tok, mesh))
            logits, cache = dec(sp, cache, tok, pos + step)
            out.append(np.asarray(logits))
    flat = {sharding._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(f"{sys.argv[1]}/out{i}.npz",
             **{f"logits{j}": x for j, x in enumerate(out)}, **flat)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_sharded):
    tmp = tmp_path_factory.mktemp("model_parallel")
    cases = {2: _cases(2), 4: _cases(4)}
    for arch, (case, _) in jax_sharded.items():
        cases[4][f"jax|{arch}"] = case
    return {w: (c, run_ranks(model_parallel, w, tmp, c, timeout=600))
            for w, c in cases.items()}


def _reference(runs, arch: str, dtype: str) -> dict:
    c2, res2 = runs[2]
    mesh = MESHES[2][0]
    return res2[0][f"{arch}|{dtype}|{mesh[0]}x{mesh[1]}|False:reference"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_match_one_process(runs, world, arch):
    cases, res = runs[world]
    family = registry.build(arch, reduced=True).cfg.family
    for name, case in cases.items():
        if not name.startswith(arch + "|"):
            continue
        dtype = case["dtype"]
        want = _reference(runs, arch, dtype)
        tol = F32_TOL if dtype == "float32" else BF16_TOL[family]
        for rank, out in enumerate(res):
            got = out[name]
            rows = got["rows"]
            for step, (g, w) in enumerate(zip(got["logits"],
                                              want["logits"])):
                np.testing.assert_allclose(
                    g, w[rows], **tol,
                    err_msg=f"{name} rank {rank} step {step}")
            if dtype == "float32":
                for g, w in zip(got["picks"], want["picks"]):
                    np.testing.assert_array_equal(g, w[rows])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_as_routes_predict(runs, world, arch):
    cases, res = runs[world]
    for name, case in cases.items():
        if not name.startswith(arch + "|float32|") or case["fsdp"]:
            continue
        _, cfg = _model_api(arch, "float32")
        if cfg.family in ("griffin", "xlstm"):
            want = (predicted_gathers(cfg, case["mesh"]),) * 2
        else:
            seq = _prompt(arch)
            want = predicted(cfg, case["mesh"][1], seq)
        for rank, out in enumerate(res):
            counts = out[name]["counts"]
            got = [{k: v["calls"] for k, v in counts[i].items()}
                   for i in (0, 1)]
            assert got == list(want), f"{name} rank {rank}"
            assert counts[2] == counts[1]           # every step the same


def _against_jax(runs, jax_sharded, arch: str) -> None:
    case, want = jax_sharded[arch]
    _, res = runs[4]
    for rank, out in enumerate(res):
        got = out[f"jax|{arch}"]
        rows = got["rows"]
        for step, w in enumerate(want):
            np.testing.assert_allclose(got["logits"][step], w[rows],
                                       **F32_TOL,
                                       err_msg=f"rank {rank} step {step}")


def test_llava_matches_jax_sharded_prefill(runs, jax_sharded):
    _against_jax(runs, jax_sharded, "llava-next-34b")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen3-1.7b"])
def test_matches_jax_sharded_decode(runs, jax_sharded, arch):
    _against_jax(runs, jax_sharded, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_is_the_ranks_blocks(arch):
    """``init(keep=block_keeper(...))`` (serve.py --mesh's draw) gives every
    rank of a 2 x 2 mesh, FSDP on and off, exactly its blocks of the whole
    model drawn from the same seed."""
    api = registry.build(arch, reduced=True)
    whole = api.init(torch.Generator().manual_seed(0))
    sizes = {"data": 2, "model": 2}
    for fsdp in (False, True):
        specs = sharding.param_specs(api.param_shapes(), api.cfg, sizes,
                                     fsdp=fsdp)
        for d in range(2):
            for m in range(2):
                coords = {"data": d, "model": m}
                got = api.init(torch.Generator().manual_seed(0),
                               keep=sharding.block_keeper(specs, sizes,
                                                          coords))
                want = sharding.map_with_path(
                    lambda p, x: sharding.shard_leaf(
                        x, sharding.spec_at(specs, p), coords, sizes), whole)
                flat_g, flat_w = ({}, {})
                sharding.map_with_path(lambda p, x: flat_g.update({p: x}),
                                       got)
                sharding.map_with_path(lambda p, x: flat_w.update({p: x}),
                                       want)
                assert flat_g.keys() == flat_w.keys()
                for p, x in flat_w.items():
                    assert torch.equal(flat_g[p], x), (fsdp, coords, p)
