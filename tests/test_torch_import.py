"""The PyTorch port imports without JAX, and none of its sources import the
JAX package or its stack (flax and msgpack included: the port reads the
JAX package's ``.aoi`` files with its own msgpack reader), nor
scikit-learn (the stat layer's decompositions are the port's own)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "atomai_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "atomai_tpu",
             "sklearn"}

SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(PKG) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]

MODULES = sorted(
    "atomai_tpu_torch" + "".join(
        "." + p for p in os.path.splitext(os.path.relpath(path, PKG))[0]
        .split(os.sep) if p != "__init__")
    for path in (os.path.join(ROOT, s) for s in SOURCES[:-1]))


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    bad = _imported_roots(os.path.join(ROOT, source)) & FORBIDDEN
    assert not bad, f"{source} imports {sorted(bad)}"


def test_import_with_jax_blocked():
    """Every module of the slice imports in a fresh interpreter in which
    ``import jax`` (and flax, atomai_tpu) fails."""
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        "import atomai_tpu_torch as aoi\n"
        f"for mod in {MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert aoi.models.Segmentor and aoi.predictors.Locator\n"
        "assert aoi.utils.make_lattice_stack and aoi.ops.label_components\n"
        "assert aoi.stat.imlocal and aoi.export_model and aoi.load_ensemble\n"
        "assert aoi.models.load_torch_checkpoint\n"
        "# no kernel is built at import: only at the first CUDA launch\n"
        "assert aoi.ops.cc_kernel._lib is None\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_plotting_or_graph_package():
    """The card's machine has neither matplotlib nor networkx."""
    bad = _imported_roots(os.path.join(ROOT, "chip_smoke.py")) & {
        "matplotlib", "networkx", "PIL"}
    assert not bad, f"chip_smoke.py imports {sorted(bad)}"
