"""The import guard: no module of the benchmark imports JAX or the JAX
package, and the plain reference (with the code that fits the served
weights) imports nothing of the program; top-level module names are
compared whole, so ``atomai_tpu_torch`` is not ``atomai_tpu``."""

import ast
import os
import sys

import pytest

import harness
from conftest import BENCH

PROGRAM = "atomai_tpu_torch"
# modules that stand beside the program and never import it
PLAIN = ("reference", "weights.py", "lattice.py", "roofline.py",
         "inputs.py")


def _sources():
    for d, _, files in os.walk(BENCH):
        if "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(_sources())
    assert len(paths) > 20
    for path in paths:
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    plain = [p for p in _sources()
             if os.path.relpath(p, BENCH).split(os.sep)[0] in PLAIN]
    assert any("reference" in p for p in plain) and len(plain) >= 7
    for path in plain:
        assert PROGRAM not in set(_imports(path)), path


def test_the_guard_compares_whole_names(monkeypatch):
    import atomai_tpu_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "atomai_tpu_torchx.core", sys)
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("name", ["jax", "flax.linen", "optax",
                                  "atomai_tpu.core"])
def test_the_guard_sees_each_forbidden_name(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, sys)
    assert name.split(".")[0] in harness.forbidden_modules()
