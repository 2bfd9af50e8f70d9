"""Builds the CUDA sources of ``atomai_tpu_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``; no PyTorch
headers are involved, so a build takes seconds. Libraries land in
``atomai_tpu_torch/_build/`` (ignored by git), named by a hash of the
source and the flags, so an edited source is rebuilt. The build writes to
a per-process temporary file and renames it into place, so concurrent
processes never load a half-written library (as
`atomai_tpu/native/__init__.py:24-44` does for its g++ builds).
:func:`compile_shared` does the same for the host's C++ sources
(``atomai_tpu_torch/native``) with ``g++``.

There is no fallback: a missing compiler or a failed build raises, with
the compiler's output. ``-Xptxas -v`` makes the assembler report each
kernel's registers, shared memory and spills; a build in this process keeps
that report in ``BUILD_LOG``, under the source's name (and its macros, for
a variant built with some: ``spatial_mlp.cu SPATIAL_MLP_SKIP``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# source -> the compiler's output of its build in this process
BUILD_LOG = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (searched PATH, $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _library_path(src_path: str, flags) -> str:
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _nvcc_flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(source: str, defines=()) -> str:
    """Where the library built from ``csrc/<source>`` (with the macros
    ``defines``) goes."""
    return _library_path(os.path.join(CSRC_DIR, source), _nvcc_flags(defines))


def compile_shared(src_path: str, compiler: str, flags, label=None) -> str:
    """Compiles ``src_path`` with ``compiler`` and ``flags`` into a shared
    library in ``BUILD_DIR`` unless an up-to-date one exists; returns the
    library's path. The compiler's output goes to ``BUILD_LOG[label]``
    (the source's name by default)."""
    lib_path = _library_path(src_path, flags)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp_path, src_path]
    name = os.path.basename(src_path)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed on {name} (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp_path, lib_path)
        BUILD_LOG[label or name] = proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return lib_path


def build(source: str, defines=()) -> str:
    """Compiles ``csrc/<source>`` with the macros ``defines`` defined
    unless an up-to-date library exists; returns the library's path."""
    return compile_shared(os.path.join(CSRC_DIR, source), find_nvcc(),
                          _nvcc_flags(defines),
                          " ".join((source,) + tuple(defines)))


def load(source: str, defines=()) -> ctypes.CDLL:
    """Builds (if needed) and loads the library of ``csrc/<source>`` (with
    the macros ``defines``)."""
    return ctypes.CDLL(build(source, defines))
