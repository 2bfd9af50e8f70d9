"""k-nearest-neighbour, ball and pair queries and DBSCAN of atom
coordinates, in C++ on the host.

Counterpart of `atomai_tpu/native/neighbors.py:78-153` (``knn``,
``ball_query``, ``query_pairs``, ``dbscan``):
- :func:`knn`: ``scipy.spatial.cKDTree.query``'s semantics: the k nearest
  points of each query in ascending distance, a miss (fewer than k within
  ``upper_bound``, the bound itself included) reported as distance ``inf``
  and index ``n``;
- :func:`ball_query`: ``cKDTree.query_ball_point``'s: the ids of the
  points within ``r`` of each query (``r`` included), ascending;
- :func:`query_pairs`: ``cKDTree.query_pairs``': every pair ``i < j``
  within ``r``, sorted by ``(i, j)`` (the grid visits partners in no
  useful order, and the lattice graph's adjacency, hence the order of its
  rings, follows this one);
- :func:`dbscan`: sklearn's semantics: a point with at least
  ``min_samples`` points within ``eps`` (itself included) is a core
  point; clusters are the connected components of core points, numbered
  in the order of their first core point; a border point takes the
  cluster that reaches it first; the rest is noise (-1).

All run ``neighbors.cpp`` (a grid hash), compiled by ``g++ -O3 -shared
-fPIC -std=c++17`` into ``atomai_tpu_torch/_build/`` at the first call,
the way ``ops/_build.py`` builds the CUDA sources. There is no fallback: a
missing ``g++`` or a failed build raises. The ``*_reference`` functions
are the plain versions (numpy and ``scipy.spatial.cKDTree``) that the
tests hold them against.
"""

import ctypes
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from ..ops._build import compile_shared

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "neighbors.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def build() -> ctypes.CDLL:
    """Compiles (if needed) and loads ``neighbors.cpp``."""
    global _lib
    if _lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the native "
                               "neighbour queries cannot be built")
        lib = ctypes.CDLL(compile_shared(SOURCE, gxx, GXX_FLAGS))
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.nn_knn.restype = None
        lib.nn_knn.argtypes = [
            ctypes.c_int, ctypes.c_int, f64, ctypes.c_int, f64, ctypes.c_int,
            ctypes.c_double, f64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        ptr32 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
        lib.nn_ball_csr.restype = None
        lib.nn_ball_csr.argtypes = [
            ctypes.c_int, ctypes.c_int, f64, ctypes.c_int, f64,
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"), ptr32]
        lib.nn_pairs.restype = ctypes.c_int64
        lib.nn_pairs.argtypes = [ctypes.c_int, ctypes.c_int, f64,
                                 ctypes.c_double, ptr32]
        lib.nn_free.restype = None
        lib.nn_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.nn_dbscan.restype = None
        lib.nn_dbscan.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        _lib = lib
    return _lib


def _points(points) -> np.ndarray:
    pts = np.ascontiguousarray(points, np.float64)
    if pts.ndim == 1:
        pts = pts[None]
    if pts.ndim != 2 or pts.shape[1] not in (2, 3):
        raise ValueError(f"points must be (n, 2) or (n, 3), got shape "
                         f"{pts.shape}")
    return pts


def knn(points, queries, k: int, upper_bound: Optional[float] = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(distances (nq, k) float64, indices (nq, k) int64) of the k nearest
    of (n, 2) or (n, 3) ``points`` to each query, nearest first; a miss
    beyond ``upper_bound`` (or past the n points) is ``inf`` and ``n``."""
    pts, q = _points(points), _points(queries)
    nq = len(q)
    d = np.full((nq, k), np.inf)
    i = np.full((nq, k), len(pts), np.int32)
    if len(pts) and nq:
        ub = np.inf if upper_bound is None else float(upper_bound)
        build().nn_knn(len(pts), pts.shape[1], pts, nq, q, int(k), ub, d, i)
    return d, i.astype(np.int64)


def knn_reference(points, queries, k: int,
                  upper_bound: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`knn`: an unbounded ``cKDTree.query``,
    then the points beyond ``upper_bound`` marked as misses (the bound
    itself included, as the grid's d^2 <= bound^2 test has it; cKDTree's
    own bound is strict)."""
    from scipy.spatial import cKDTree
    pts, q = _points(points), _points(queries)
    d, i = cKDTree(pts).query(q, k=k)
    d = np.asarray(d, np.float64).reshape(len(q), k)
    i = np.asarray(i, np.int64).reshape(len(q), k)
    if upper_bound is not None:
        miss = ~(d <= float(upper_bound))
        d[miss], i[miss] = np.inf, len(pts)
    return d, i


def _take(lib, buf, count: int) -> np.ndarray:
    """``count`` int32 values of a buffer the library allocated, as int64;
    the buffer is released."""
    try:
        return np.ctypeslib.as_array(buf, (max(count, 1),))[:count].astype(
            np.int64)
    finally:
        lib.nn_free(buf)


def ball_query(points, queries, r: float) -> List[np.ndarray]:
    """For each query, the ascending int64 ids of the (n, 2) or (n, 3)
    ``points`` within ``r`` of it (``r`` included)."""
    pts, q = _points(points), _points(queries)
    nq = len(q)
    if not len(pts):
        return [np.empty(0, np.int64) for _ in range(nq)]
    lib = build()
    indptr = np.empty(nq + 1, np.int64)
    buf = ctypes.POINTER(ctypes.c_int32)()
    lib.nn_ball_csr(len(pts), pts.shape[1], pts, nq, q, float(r), indptr,
                    ctypes.byref(buf))
    flat = _take(lib, buf, int(indptr[-1]))
    return np.split(flat, indptr[1:-1])


def ball_query_reference(points, queries, r: float) -> List[np.ndarray]:
    """The plain version of :func:`ball_query`:
    ``cKDTree.query_ball_point``, each list sorted."""
    from scipy.spatial import cKDTree
    pts, q = _points(points), _points(queries)
    if not len(pts):
        return [np.empty(0, np.int64) for _ in range(len(q))]
    return [np.sort(np.asarray(b, np.int64))
            for b in cKDTree(pts).query_ball_point(q, r=float(r))]


def _sorted_pairs(pairs: np.ndarray) -> np.ndarray:
    pairs = pairs.reshape(-1, 2)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def query_pairs(points, r: float) -> np.ndarray:
    """(m, 2) int64 pairs ``i < j`` of (n, 2) or (n, 3) ``points`` within
    ``r`` of each other (``r`` included), sorted by ``(i, j)``."""
    pts = _points(points)
    if not len(pts):
        return np.empty((0, 2), np.int64)
    lib = build()
    buf = ctypes.POINTER(ctypes.c_int32)()
    m = int(lib.nn_pairs(len(pts), pts.shape[1], pts, float(r),
                         ctypes.byref(buf)))
    return _sorted_pairs(_take(lib, buf, 2 * m))


def query_pairs_reference(points, r: float) -> np.ndarray:
    """The plain version of :func:`query_pairs`: ``cKDTree.query_pairs``,
    sorted by ``(i, j)``."""
    from scipy.spatial import cKDTree
    pts = _points(points)
    if not len(pts):
        return np.empty((0, 2), np.int64)
    return _sorted_pairs(cKDTree(pts).query_pairs(
        float(r), output_type="ndarray").astype(np.int64))


def dbscan(points, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels (int64, noise -1) of (n, 2) or (n, 3) points."""
    pts = _points(points)
    labels = np.empty(len(pts), np.int32)
    if len(pts):
        build().nn_dbscan(len(pts), pts.shape[1], pts, float(eps),
                          int(min_samples), labels)
    return labels.astype(np.int64)


def dbscan_reference(points, eps: float, min_samples: int) -> np.ndarray:
    """The plain version of :func:`dbscan`: eps-balls from a cKDTree, then
    the same expansion from core points in index order."""
    from scipy.spatial import cKDTree
    pts = _points(points)
    n = len(pts)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    balls = cKDTree(pts).query_ball_point(pts, r=float(eps))
    core = np.array([len(b) >= min_samples for b in balls])
    label = 0
    for i in range(n):
        if not core[i] or labels[i] != -1:
            continue
        labels[i] = label
        stack = [i]
        while stack:
            u = stack.pop()
            if not core[u]:
                continue
            for v in balls[u]:
                if labels[v] == -1:
                    labels[v] = label
                    stack.append(v)
        label += 1
    return labels
