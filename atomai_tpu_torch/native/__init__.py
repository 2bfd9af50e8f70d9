"""Host-side C++ components, built with ``g++`` at first use and loaded with
``ctypes``: the grid-hash k-NN of ``chain_tracks`` and DBSCAN of
``cluster_coord`` (:mod:`.neighbors`).
"""

from .neighbors import dbscan, dbscan_reference, knn, knn_reference

__all__ = ["dbscan", "dbscan_reference", "knn", "knn_reference"]
