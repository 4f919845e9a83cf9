"""The port's dry run (launch/dryrun.py): one rank's sharded program on
``meta`` tensors inside a fake process group of the mesh's world size.

One reduced cell of each kind — smollm-135m train_4k (an AdamW step), its
prefill_32k, qwen3-1.7b decode_32k — and recurrentgemma-9b decode_32k
(whose states the program holds batch-split and whole over ``model``) on
a fake 2 x 4 mesh, as tests/test_dryrun_smoke.py does for the JAX
package, in a subprocess (the fake process group is process-wide state):
FLOPs > 0, collectives issued, and the rank's bytes equal to what the
specs imply, summed here leaf by leaf from ``local_shape`` (griffin's held
states from ``init_states`` at the rank's batch).  Then kimi-k2-1t-a32b at full width on 16 x 16
and 2 x 16 x 16, shapes only (no program): the same bytes check, and the
numbers the dry run reports for it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import production_shapes  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

CELLS = [("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
         ("qwen3-1.7b", "decode_32k"), ("recurrentgemma-9b", "decode_32k")]
MESH = {"data": 2, "model": 4}

SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
cells = json.loads(sys.argv[1])
out = {f"{a}|{s}": dryrun.run_cell(a, s, {"data": 2, "model": 4},
                                   reduced=True) for a, s in cells}
print(json.dumps(out))
"""


def _spec_bytes(shapes, specs, sizes) -> int:
    """One rank's bytes of ``shapes`` under ``specs``, leaf by leaf."""
    total = []
    flat = {}
    sharding.map_with_path(lambda p, s: flat.__setitem__(p, s), specs)
    sharding.map_with_path(lambda p, x: total.append(
        math.prod(sharding.local_shape(tuple(x.shape), flat[p], sizes))
        * x.dtype.itemsize), shapes)
    return sum(total)


def _check_bytes(rec: dict, arch: str, shape: str, sizes: dict,
                 reduced: bool) -> None:
    spec = build_cell(arch, shape, sizes, reduced=reduced)
    api = build(arch, reduced=reduced)
    assert rec["param_bytes"] == _spec_bytes(spec.abstract_args[0],
                                             spec.param_specs, sizes)
    assert rec["input_bytes"] == _spec_bytes(api.input_specs(shape),
                                             spec.batch_specs, sizes)
    kind = SHAPES[shape].kind
    opt = (_spec_bytes(spec.abstract_args[1], spec.opt_specs, sizes)
           if kind == "train" else 0)
    cache = (_spec_bytes(spec.abstract_args[1], spec.cache_specs, sizes)
             if kind == "decode" else 0)
    assert (rec["opt_bytes"], rec["cache_bytes"]) == (opt, cache)
    held = cache
    if kind == "decode" and api.cfg.family in ("griffin", "xlstm"):
        import importlib
        from repro_torch.models.registry import FAMILY_MODULES
        fam = importlib.import_module(FAMILY_MODULES[api.cfg.family])
        n = sizes.get("pod", 1) * sizes["data"]
        states = fam.init_states(api.cfg, SHAPES[shape].global_batch // n,
                                 device="meta")
        held = sum(x.numel() * x.element_size()
                   for x in sharding.spec_leaves(states))
        assert rec["cache_held_bytes"] == held
    assert rec["rank_bytes"] == (rec["param_bytes"] + opt + held
                                 + rec["input_bytes"])


def test_reduced_cells_on_a_fake_mesh(tmp_path):
    src = str(Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, json.dumps(CELLS)],
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin:/usr/local/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch, shape in CELLS:
        rec = out[f"{arch}|{shape}"]
        assert rec["status"] == "ok", rec
        assert rec["flops"] > 0, (arch, shape)
        assert rec["collectives"]["all_gather"]["calls"] > 0
        assert rec["collective_bytes"] > 0
        assert rec["n_devices"] == 8 and rec["fits_80gb"]
        _check_bytes(rec, arch, shape, MESH, True)


@pytest.mark.parametrize("mesh", list(production_shapes()))
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_kimi_k2_full_width_shapes_only(mesh, shape):
    """kimi-k2 (1.03·10¹² parameters, FSDP) on a production mesh from its
    specs alone: 4 bytes a parameter over ~256 ranks (the pod axis
    replicates), and the AdamW moments twice that."""
    sizes = production_shapes()[mesh]
    rec = dryrun.run_cell("kimi-k2-1t-a32b", shape, sizes, flops=False)
    assert rec["status"] == "ok" and rec["fsdp"]
    assert "flops" not in rec
    _check_bytes(rec, "kimi-k2-1t-a32b", shape, sizes, False)
    total = rec["params_total"]
    assert total > 1e12
    assert rec["param_bytes"] < 4 * total / 200      # split ~256 ways
    if shape == "train_4k":
        # the two float32 moments and the int32 step counter
        assert rec["opt_bytes"] == 2 * rec["param_bytes"] + 4
