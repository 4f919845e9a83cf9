"""The port's PartitionSpec rules (``distributed/sharding.py``'s model
half) against the JAX package's, leaf by leaf, with no device: JAX's specs
come from ``jax.eval_shape`` shapes on a ``jax.sharding.AbstractMesh`` of
the production sizes, the port's from its ``meta`` shapes on the same
axis sizes.

For every architecture at full width, fsdp off and on, on 16 x 16 and
2 x 16 x 16: ``param_specs`` equal (a port spec is a tuple equal to the
``PartitionSpec``), and one rank's parameter bytes from the port's
``local_shape`` equal those the JAX specs imply.  For every supported
(arch, shape) cell: ``batch_specs`` and ``cache_specs`` equal, and
``opt_specs`` of the AdamW state that ``launch/steps.build_cell`` makes.
"""

from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.shapes import SHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.registry import build as jbuild, list_archs  # noqa: E402
from repro.optim.sgd import OptimizerConfig as JOpt  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models.registry import build as tbuild  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

MESHES = tmesh.production_shapes()


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_flat(tree) -> dict:
    """{path: leaf} of a JAX tree, paths as the port joins them."""
    return {jsh._path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                   PartitionSpec))[0]}


def _port_flat(tree) -> dict:
    out = {}
    tsh.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _same_specs(port_tree, jax_tree, where: str) -> None:
    got, want = _port_flat(port_tree), _jax_flat(jax_tree)
    assert set(got) == set(want), where
    bad = {p: (got[p], tuple(want[p])) for p in want
           if tuple(got[p]) != tuple(want[p])}
    assert not bad, f"{where}: {bad}"


@pytest.fixture(scope="module")
def shapes():
    """(JAX eval_shape params, port meta params) of every arch."""
    return {a: (jbuild(a).param_shapes(), tbuild(a).param_shapes())
            for a in list_archs()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(shapes, arch, fsdp, mesh):
    sizes = MESHES[mesh]
    jshapes, tshapes = shapes[arch]
    cfg = jbuild(arch).cfg
    want = jsh.param_specs(jshapes, cfg, _abstract(sizes), fsdp=fsdp)
    got = tsh.param_specs(tshapes, tbuild(arch).cfg, sizes, fsdp=fsdp)
    _same_specs(got, want, f"{arch} {mesh} fsdp={fsdp}")
    # one rank's bytes: the port's local_shape against the JAX specs' blocks
    jbytes = 0
    for p, x in _jax_flat(jshapes).items():
        spec = _jax_flat(want)[p]
        block = [d // jsh._axis_size(_abstract(sizes), a)
                 for d, a in zip(x.shape, tuple(spec) + (None,) * (
                     len(x.shape) - len(spec)))]
        jbytes += math.prod(block) * x.dtype.itemsize
    assert tsh.local_bytes(tshapes, got, sizes) == jbytes


CELLS = [(a, s) for a in list_archs() for s in SHAPES
         if jbuild(a).supports(s)[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_match_jax(shapes, arch, shape, mesh):
    """batch, cache and optimizer-state specs of one cell."""
    sizes = MESHES[mesh]
    am = _abstract(sizes)
    japi, tapi = jbuild(arch), tbuild(arch)
    where = f"{arch} x {shape} on {mesh}"
    _same_specs(tsh.batch_specs(tapi.input_specs(shape), sizes),
                jsh.batch_specs(japi.input_specs(shape), am), where)
    cell = build_cell(arch, shape, sizes)
    if SHAPES[shape].kind == "decode":
        _same_specs(cell.cache_specs,
                    jsh.cache_specs(japi.decode_state_specs(shape),
                                    japi.cfg, am), where)
    if SHAPES[shape].kind == "train":
        jp = jsh.param_specs(shapes[arch][0], japi.cfg, am,
                             fsdp=cell.static["fsdp"])
        opt = JOpt(name="adamw", lr=3e-4, weight_decay=0.1).build()
        oshapes = jax.eval_shape(opt.init, shapes[arch][0])
        _same_specs(cell.opt_specs, jsh.opt_specs(oshapes, jp), where)
