"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py or the port's harnesses (benchmarks/torch_*.py) imports JAX
or the JAX package ``repro``, so the port runs on a machine that has
neither.  tests/_torch_dist.py, whose functions run in spawned ranks,
imports neither either."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist.py"] + sorted(
    (ROOT / "benchmarks").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    mods = list(_imported_modules(ast.parse(path.read_text(), str(path))))
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_sees_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import bandit_jax\n"
           "import importlib\nimportlib.import_module('repro.sim')\n")
    assert list(_imported_modules(ast.parse(src))) == [
        "jax.numpy", "repro.core", "importlib", "repro.sim"]
