"""The port's cohort-parallel FL round (repro_torch.distributed.fl_parallel)
against the JAX package's ``repro.distributed.fl_parallel``, on the CPU.

The JAX side runs once, in a subprocess whose environment alone carries
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (a [4, 1]
("data", "model") mesh, one cohort a device); the port runs the same
numpy inputs on 1 process and on 2 and 4 gloo ranks (tests/_torch_dist.py),
C/R cohorts a rank:

  1. ``fedavg_across_cohorts`` of given stacked models for every compress
     mode (none, int8, int8_psum, topk);
  2. one ``make_fl_round`` of a small CNN (BatchNorm off), 4 cohorts, 2
     local SGD steps at lr 0.1, weights [1, 0, 2, 1] (cohort 1 unselected),
     for every compress mode: the new global model and the mean loss.

Tolerance (float32): every leaf within 1e-6 of its largest entry, the
mean loss within rtol 1e-6.  Measured: at most 2.03e-7 of the largest
entry in (1) and (2).  In (1) the int8 codes, shared scales and top-k
indices are JAX's, so only the combine's summation order differs; in (2)
the local steps' gradients also differ from ``jax.vmap(jax.grad)`` by
float32 rounding, which SGD carries into the models.  The compressed
modes gather every cohort and combine once, so on 2 and 4 ranks their
results are bitwise the one-process ones; ``none`` sums each rank's
partial, so its ranks agree bitwise with each other only.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist import cohort_checks, run_ranks  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import fl_parallel  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

C, STEPS, BATCH, LR, RATIO = 4, 2, 8, 0.1, 0.05
WEIGHTS = np.array([1.0, 0.0, 2.0, 1.0], np.float32)
SMALL_CNN = dict(image_size=8, channels=(8, 8), pool_after=(0,),
                 fc_units=(16,), batchnorm=False)
MODES = fl_parallel.COMPRESS

JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed import fl_parallel
from repro.models import cnn
from repro.optim.sgd import OptimizerConfig

assert jax.device_count() == 4
inp = np.load(sys.argv[1])
cfg_kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in json.loads(sys.argv[3]).items()}
C, steps = int(inp["C"]), int(inp["steps"])
lr, ratio = float(inp["lr"]), float(inp["ratio"])
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 1), ("data", "model"))
cfg = cnn.CnnConfig(**cfg_kw)

def unflat(prefix):
    tree = {}
    for k in inp.files:
        if k.startswith(prefix):
            layer, leaf = k[len(prefix):].split("/")
            tree.setdefault(layer, {})[leaf] = jnp.asarray(inp[k])
    return tree

def flat(tree, prefix):
    return {f"{prefix}{l}/{n}": np.asarray(v) for l, d in tree.items()
            for n, v in d.items()}

params, stacked, base = unflat("params0:"), unflat("stacked:"), unflat("base:")
specs = jax.tree.map(lambda x: P(("data",), *([None] * x.ndim)), params)
weights = jnp.asarray(inp["weights"])
out = {}
for mode in ["none", "int8", "int8_psum", "topk"]:
    agg = jax.jit(lambda s, w, b: fl_parallel.fedavg_across_cohorts(
        s, w, mesh, specs, compress=mode, topk_ratio=ratio,
        base_params=b))(stacked, weights, base)
    out.update(flat(agg, f"combine_{mode}:"))
opt = OptimizerConfig(name="sgd", lr=lr, lr_decay=0.0).build()
opt_state = jax.vmap(opt.init)(fl_parallel.stack_for_cohorts(params, C))
batches = {"x": jnp.asarray(inp["x"]), "y": jnp.asarray(inp["y"])}
loss_fn = lambda p, b: cnn.loss_fn(p, b, cfg)[0]
for mode in ["none", "int8", "int8_psum", "topk"]:
    fl_round = fl_parallel.make_fl_round(loss_fn, opt, steps, mesh, specs,
                                         compress=mode, topk_ratio=ratio)
    new, _, loss = jax.jit(fl_round)(params, opt_state, batches, weights)
    out.update(flat(new, f"round_{mode}:"))
    out[f"loss_{mode}"] = np.float32(loss)
np.savez(sys.argv[2], **out)
"""


def _leaf_close(got, want, rtol, where):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, f"{where}: {err:.3g} > {rtol} x {scale:.3g}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fl_parallel")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, STEPS, BATCH, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (C, STEPS, BATCH)).astype(np.int32)
    inp = {"C": C, "steps": STEPS, "lr": LR, "ratio": RATIO,
           "weights": WEIGHTS, "x": x, "y": y}
    # the JAX init, and random stacked models of its shapes to combine
    p0 = jcnn.init(jax.random.PRNGKey(0), jcnn.CnnConfig(**SMALL_CNN))
    keys = [f"{layer}/{leaf}" for layer in p0 for leaf in p0[layer]]
    for k in keys:
        layer, leaf = k.split("/")
        x0 = np.asarray(p0[layer][leaf], np.float32)
        inp["params0:" + k] = x0
        inp["base:" + k] = rng.standard_normal(x0.shape).astype(np.float32)
        inp["stacked:" + k] = (inp["base:" + k][None] + 0.1
                               * rng.standard_normal((C,) + x0.shape)
                               ).astype(np.float32)
    np.savez(tmp / "in.npz", **inp)
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(SMALL_CNN)],
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": str(tmp), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                          "--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jx = dict(np.load(tmp / "out.npz"))

    def port(get) -> dict:          # JAX layout -> the port's, numpy
        return {n: v.numpy() for n, v in convert.cnn_params_from_jax(
            {layer: {leaf: get(f"{layer}/{leaf}") for leaf in p0[layer]}
             for layer in p0}).items()}
    stacked = {n: np.stack(v) for n, v in zip(
        port(lambda k: inp["base:" + k]),
        zip(*(port(lambda k: inp["stacked:" + k][i]).values()
              for i in range(C))))}
    base = port(lambda k: inp["base:" + k])
    params0 = port(lambda k: inp["params0:" + k])
    batches = {"x": np.ascontiguousarray(x.transpose(0, 1, 2, 5, 3, 4)),
               "y": y.astype(np.int64)}
    combine = (stacked, base, WEIGHTS, RATIO)
    rounds = (params0, batches, WEIGHTS, SMALL_CNN, STEPS, LR, RATIO)
    want = {"combine": {m: port(lambda k: jx[f"combine_{m}:" + k])
                        for m in MODES},
            "round": {m: (port(lambda k: jx[f"round_{m}:" + k]),
                          float(jx[f"loss_{m}"])) for m in MODES}}
    got = {1: [cohort_checks(0, 1, combine, rounds)]}
    for world in (2, 4):
        got[world] = run_ranks(cohort_checks, world, tmp, combine, rounds)
    return want, got


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_fedavg_across_cohorts_matches_jax(runs, mode, world):
    want, got = runs
    same = (got[world] if mode == "none" else got[1])[0]["combine"][mode]
    for rank, res in enumerate(got[world]):
        for name, ref in want["combine"][mode].items():
            _leaf_close(res["combine"][mode][name], ref, 1e-6,
                        f"{mode} {name} rank {rank}/{world}")
            assert np.array_equal(res["combine"][mode][name], same[name])


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_fl_round_matches_jax(runs, mode, world):
    want, got = runs
    ref_params, ref_loss = want["round"][mode]
    for rank, res in enumerate(got[world]):
        params, loss = res["round"][mode]
        assert loss == pytest.approx(ref_loss, rel=1e-6)
        for name, ref in ref_params.items():
            _leaf_close(params[name], ref, 1e-6,
                        f"{mode} {name} rank {rank}/{world}")


def test_fl_round_refuses_unknown_modes():
    opt = None
    with pytest.raises(ValueError, match="compress"):
        fl_parallel.make_fl_round(lambda p, b: 0.0, opt, 1, compress="zip")
    with pytest.raises(ValueError, match="weights"):
        fl_parallel.fedavg_across_cohorts({"w": torch.zeros(3, 2)},
                                          torch.ones(4))
