"""Rings of a lattice graph, in C++ on the host.

Counterpart of `atomai_tpu/native/__init__.py:78-111`
(``find_rings_native``) and of the Python ring search of
`atomai_tpu/utils/graphx.py:85-157`:

- :func:`find_rings_native` runs ``graph_rings.cpp`` (the JAX package's
  source, copied as it is): every simple cycle of 3 to ``max_depth``
  members, each reported once, rooted at its smallest member id; with
  ``filter_filled``, only the chordless ones (no two members closer
  through the graph than along the ring). The library is compiled by
  ``g++`` into ``atomai_tpu_torch/_build/`` at the first call, as
  :mod:`.neighbors` is; a missing ``g++`` or a failed build raises.
- :func:`find_rings_reference` is the plain version: an iterative
  canonical DFS (walking only ids above the root, the orientation fixed
  by ``path[1] < path[-1]``) and a bounded BFS for the chords.

On adjacency lists in ascending order (what ``Graph.find_neighbors``
builds from the sorted pairs of :func:`.neighbors.query_pairs`) the two
give the same rings, members and order alike: the C++ search's erasure of
a root from its finished neighbours' lists closes a ring exactly when its
last member comes after its second in the root's list.
"""

import ctypes
import os
import shutil
from typing import List, Sequence

import numpy as np

from ..ops._build import compile_shared
from .neighbors import GXX_FLAGS

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "graph_rings.cpp")
_lib = None


def build() -> ctypes.CDLL:
    """Compiles (if needed) and loads ``graph_rings.cpp``."""
    global _lib
    if _lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the native ring "
                               "search cannot be built")
        lib = ctypes.CDLL(compile_shared(SOURCE, gxx, GXX_FLAGS))
        out = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
        lib.find_rings_native.restype = ctypes.c_int
        lib.find_rings_native.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, out, out]
        lib.free_buffer.restype = None
        lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    return _lib


def _csr(adjacency: Sequence[Sequence[int]]):
    """(indptr (n+1,) int64, indices int32) of an adjacency list."""
    sizes = np.fromiter((len(nb) for nb in adjacency), np.int64,
                        len(adjacency))
    indptr = np.zeros(len(adjacency) + 1, np.int64)
    np.cumsum(sizes, out=indptr[1:])
    indices = np.fromiter((v for nb in adjacency for v in nb), np.int32,
                          int(indptr[-1]))
    return indptr, (indices if len(indices) else np.zeros(1, np.int32))


def find_rings_native(adjacency: Sequence[Sequence[int]], max_depth: int,
                      filter_filled: bool = True) -> List[List[int]]:
    """The rings of a graph given as adjacency lists (vertex ids 0..n-1),
    each a list of member ids from its root, in the search's order."""
    lib = build()
    n = len(adjacency)
    indptr, indices = _csr(adjacency)
    flat_p = ctypes.POINTER(ctypes.c_int32)()
    sizes_p = ctypes.POINTER(ctypes.c_int32)()
    n_rings = lib.find_rings_native(n, indptr, indices, int(max_depth),
                                    int(filter_filled), ctypes.byref(flat_p),
                                    ctypes.byref(sizes_p))
    try:
        sizes = np.ctypeslib.as_array(sizes_p, (max(n_rings, 1),))[
            :n_rings].astype(np.int64)
        total = int(sizes.sum())
        flat = np.ctypeslib.as_array(flat_p, (max(total, 1),))[
            :total].tolist()
    finally:
        lib.free_buffer(flat_p)
        lib.free_buffer(sizes_p)
    ends = np.cumsum(sizes).tolist()
    return [flat[e - s:e] for s, e in zip(sizes.tolist(), ends)]


def enumerate_cycles(adj: Sequence[Sequence[int]], max_size: int
                     ) -> List[List[int]]:
    """Every simple cycle of 3..``max_size`` members, each once: rooted at
    its smallest member id (the DFS walks only ids above the root), its
    orientation fixed by ``path[1] < path[-1]``; an explicit stack, no
    recursion."""
    n = len(adj)
    cycles: List[List[int]] = []
    on_path = np.zeros(n, bool)
    for root in range(n):
        path = [root]
        on_path[root] = True
        stack = [[root, 0]]
        while stack:
            frame = stack[-1]
            v, it = frame
            if it < len(adj[v]):
                frame[1] += 1
                w = adj[v][it]
                if w == root:
                    if len(path) >= 3 and path[1] < path[-1]:
                        cycles.append(path.copy())
                elif w > root and not on_path[w] and len(path) < max_size:
                    path.append(w)
                    on_path[w] = True
                    stack.append([w, 0])
            else:
                stack.pop()
                on_path[path.pop()] = False
    return cycles


def _bfs_distance(adj: Sequence[Sequence[int]], a: int, b: int,
                  max_len: int) -> int:
    """Graph distance from a to b counted in nodes (path length + 1),
    searched within ``max_len`` nodes; 0 when b is not reached."""
    if a == b:
        return 1
    dist = {a: 1}
    frontier = [a]
    while frontier:
        nxt = []
        for v in frontier:
            dv = dist[v]
            if dv >= max_len:
                continue
            for w in adj[v]:
                if w not in dist:
                    if w == b:
                        return dv + 1
                    dist[w] = dv + 1
                    nxt.append(w)
        frontier = nxt
    return 0


def is_chordless(adj: Sequence[Sequence[int]], ring: Sequence[int]) -> bool:
    """True when no two members of ``ring`` are closer through the graph
    than along the ring (the "filled polygon" test)."""
    size = len(ring)
    for j in range(size):
        for k in range(j + 2, size):
            dist_r = min(k - j, size - (k - j)) + 1
            dist_g = _bfs_distance(adj, ring[j], ring[k], dist_r)
            if dist_g and dist_g < dist_r:
                return False
    return True


def find_rings_reference(adjacency: Sequence[Sequence[int]], max_depth: int,
                         filter_filled: bool = True) -> List[List[int]]:
    """The plain version of :func:`find_rings_native`."""
    rings = enumerate_cycles(adjacency, max_depth)
    if filter_filled:
        rings = [r for r in rings if is_chordless(adjacency, r)]
    return rings
