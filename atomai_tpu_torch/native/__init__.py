"""Host-side C++ components, built with ``g++`` at first use and loaded with
``ctypes``: the grid-hash k-NN, ball and pair queries and DBSCAN
(:mod:`.neighbors`), and the ring search of the lattice graph
(:mod:`.rings`).
"""

from .neighbors import (ball_query, ball_query_reference, dbscan,
                        dbscan_reference, knn, knn_reference, query_pairs,
                        query_pairs_reference)
from .rings import find_rings_native, find_rings_reference

__all__ = ["ball_query", "ball_query_reference", "dbscan",
           "dbscan_reference", "knn", "knn_reference", "query_pairs",
           "query_pairs_reference", "find_rings_native",
           "find_rings_reference"]
