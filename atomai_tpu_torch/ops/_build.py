"""Builds the CUDA sources of ``atomai_tpu_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``; no PyTorch
headers are involved, so a build takes seconds. Libraries land in
``atomai_tpu_torch/_build/`` (ignored by git), named by a hash of the
source and the flags, so an edited source is rebuilt. The build writes to
a per-process temporary file and renames it into place, so concurrent
processes never load a half-written library (as
`atomai_tpu/native/__init__.py:24-44` does for its g++ builds).

There is no fallback: a missing ``nvcc`` or a failed build raises, with
the compiler's output. ``-Xptxas -v`` makes the assembler report each
kernel's registers, shared memory and spills; a build in this process keeps
that report in ``BUILD_LOG``.
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


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` goes."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compiles ``csrc/<source>`` unless an up-to-date library exists;
    returns the library's path."""
    lib_path = library_path(source)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp_path,
           os.path.join(CSRC_DIR, source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_path, lib_path)
        BUILD_LOG[source] = proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return lib_path


def load(source: str) -> ctypes.CDLL:
    """Builds (if needed) and loads the library of ``csrc/<source>``."""
    return ctypes.CDLL(build(source))
