"""Host-side C++ components, built with ``g++`` at first use and loaded with
``ctypes``: the grid-hash DBSCAN of ``cluster_coord`` (:mod:`.neighbors`).
"""

from .neighbors import dbscan, dbscan_reference

__all__ = ["dbscan", "dbscan_reference"]
