"""The plain reference of the post-processing: maps -> atoms -> clusters.

- :func:`locate`: AtomAI's Locator for one-class maps: threshold, 4-connected
  components (``scipy.ndimage.label``), centres of mass in float64, the rows
  within ``dist_edge`` of a frame's edge dropped. Components come in raster
  order of their first pixel, frame by frame.
- :func:`dbscan`: DBSCAN with eps-balls by squared distance (``<= eps**2``,
  the point itself included), clusters grown from core points in index
  order; noise is -1.
- :func:`cluster_means`: AtomAI's ``cluster_coord``: every member's atoms of
  one frame on one plane, clustered, each cluster's mean [row, col].

``coord_dtype`` makes it the control: the centres and the cluster means are
rounded to that dtype (the configuration states float32).
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import cKDTree


def _round(a: np.ndarray, dtype: Optional[torch.dtype]) -> np.ndarray:
    if dtype is None:
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).double() \
        .numpy()


def locate(maps: np.ndarray, threshold: float = 0.5, dist_edge: int = 5,
           coord_dtype: Optional[torch.dtype] = None
           ) -> Dict[int, np.ndarray]:
    """{frame: (k, 3) float64 [row, col, class 0]} of (n, h, w[, 1]) maps."""
    maps = np.asarray(maps)
    if maps.ndim == 4:
        maps = maps[..., 0]
    n, h, w = maps.shape
    out = {}
    for i in range(n):
        mask = maps[i] > threshold
        lab, k = ndimage.label(mask)
        if k == 0:
            out[i] = np.zeros((0, 3))
            continue
        com = np.asarray(ndimage.center_of_mass(mask, lab, range(1, k + 1)),
                         np.float64).reshape(k, 2)
        com = _round(com, coord_dtype)
        r, c = com[:, 0], com[:, 1]
        keep = ~((r > h - dist_edge) | (r < dist_edge) |
                 (c > w - dist_edge) | (c < dist_edge))
        out[i] = np.concatenate([com[keep], np.zeros((keep.sum(), 1))], 1)
    return out


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels of (n, d) points."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    eps2 = eps * eps
    cand = cKDTree(pts).query_ball_point(pts, r=eps * (1 + 1e-9) + 1e-12)
    balls = [[j for j in c if ((pts[i] - pts[j]) ** 2).sum() <= eps2]
             for i, c in enumerate(cand)]
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


def cluster_means(member_coords: List[np.ndarray], eps: float,
                  min_samples: int, coord_dtype: Optional[torch.dtype] = None
                  ) -> np.ndarray:
    """(clusters, 2) mean [row, col] of one frame's atoms over members."""
    pts = np.concatenate([np.asarray(c)[:, :2] for c in member_coords]) \
        if member_coords else np.zeros((0, 2))
    labels = dbscan(pts, eps, min_samples)
    means = [pts[labels == k].mean(0) for k in np.unique(labels[labels >= 0])]
    means = np.asarray(means, np.float64).reshape(-1, 2)
    return _round(means, coord_dtype)
