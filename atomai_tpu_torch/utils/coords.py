"""Pixel-coordinate grids of the rVAE, atom-position refinement, the
clustering of an ensemble's coordinates and the tracking of atoms through
a stack (counterpart of `atomai_tpu/utils/coords.py:51-81, 123-146,
208-269, 292-341`)."""

import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..native import dbscan, knn
from ..ops.peakfit import refine_peaks


def grid2xy(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """(M, N) grids -> (M*N, 2) xy coordinates."""
    X = torch.stack([X1, X2])
    return X.reshape(2, -1).T


def imcoordgrid(im_dim: Tuple[int, int],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(h*w, 2) float32 grid: x runs -1 -> 1 over rows, y runs 1 -> -1 over
    columns (``meshgrid`` with ``indexing="ij"``). The values are the
    correctly rounded ones (numpy's float64 ``linspace`` cast once); XLA's
    float32 ``linspace`` in the JAX package is up to 2 ulp off them."""
    xx = torch.from_numpy(np.linspace(-1, 1, im_dim[0]).astype(np.float32))
    yy = torch.from_numpy(np.linspace(1, -1, im_dim[1]).astype(np.float32))
    x0, x1 = torch.meshgrid(xx, yy, indexing="ij")
    return grid2xy(x0, x1).contiguous().to(device)


def transform_coordinates(coord: torch.Tensor, phi: torch.Tensor,
                          coord_dx: Union[torch.Tensor, float] = 0
                          ) -> torch.Tensor:
    """Rotates (B, N, 2) coordinates by ``phi`` (B,) and shifts them by
    ``coord_dx`` ((B, 1 or N, 2) or 0). The rotation matrix has rows
    [cos, sin] and [-sin, cos]; the product runs in float32 with autocast
    off, whatever scope the caller is in."""
    with torch.autocast(coord.device.type, enabled=False):
        coord = coord.float()
        phi = phi.float()
        c, s = torch.cos(phi), torch.sin(phi)
        rotmat = torch.stack([torch.stack([c, s], 1),
                              torch.stack([-s, c], 1)], 1)   # (B, 2, 2)
        coord = torch.einsum("bnk,bkm->bnm", coord, rotmat)
        return coord + coord_dx


def mean_nn_distance(coordinates: np.ndarray, nn: int = 2) -> float:
    """Mean distance of each atom to its ``nn`` nearest neighbours
    (``scipy.spatial.cKDTree``); atoms with fewer neighbours are left
    out."""
    from scipy.spatial import cKDTree
    xy = np.asarray(coordinates, np.float64)[:, :2]
    d, _ = cKDTree(xy).query(xy, k=nn + 1)
    d = d[:, 1:]
    return float(np.mean(d[np.isfinite(d).all(axis=1)]))


def peak_refinement(imgdata: Union[np.ndarray, torch.Tensor],
                    coordinates: np.ndarray, d: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> np.ndarray:
    """Refines (n, 3) [row, col, class] atom positions by batched 2D
    Gaussian fits in windows of half-side ``d`` (default a quarter of the
    mean nearest-neighbour distance); returns float64 [row, col, class].
    A tensor image is fitted on its own device; a numpy image on
    ``device`` (default ``"cuda"``, which raises where torch sees no card;
    ``device="cpu"`` fits on the CPU)."""
    if not isinstance(imgdata, torch.Tensor):
        imgdata = torch.from_numpy(np.asarray(imgdata, np.float32)).to(
            resolve_device(device))
    if d is None:
        warnings.warn(
            "The d-value for bounding box not found. Defaulting to 1/4 of "
            "mean atomic distance.", stacklevel=2)
        d = int(mean_nn_distance(coordinates) * 0.25)
    img = imgdata.float()
    xy = torch.as_tensor(np.asarray(coordinates[:, :2], np.float32),
                         device=img.device)
    refined = refine_peaks(img, xy, int(d)).cpu().numpy()
    return np.concatenate([refined, coordinates[:, 2:3]], axis=-1)


def cluster_coord(coord_class_dict: Dict[int, np.ndarray], eps: float,
                  min_samples: int = 10) -> Tuple[np.ndarray, ...]:
    """Collapses a stack's coordinates {i: (n, 3) [row, col, class]} onto
    one plane and clusters them by DBSCAN (:func:`native.dbscan`): (the
    clusters' rows as an object array, their mean [row, col], their
    variance). Only the noise label -1 is left out (original atomai drops
    the first label whether or not it is noise); with no coordinates at
    all the result is empty."""
    coordinates_all = np.concatenate(
        [coord_class_dict[k] for k in range(len(coord_class_dict))])
    if len(coordinates_all) == 0:
        empty2 = np.empty((0, 2), dtype=float)
        return np.array([], dtype=object), empty2, empty2
    labels = dbscan(coordinates_all[:, :2], eps, min_samples)
    clusters, clusters_var, clusters_mean = [], [], []
    for lbl in np.unique(labels[labels >= 0]):
        coord = coordinates_all[np.where(labels == lbl)]
        clusters.append(coord)
        clusters_mean.append(np.mean(coord[:, :2], axis=0))
        clusters_var.append(np.var(coord[:, :2], axis=0))
    return (np.array(clusters, dtype=object), np.array(clusters_mean),
            np.array(clusters_var))


def chain_tracks(coord_class_dict: Dict[int, np.ndarray],
                 starts: np.ndarray, rmax: float,
                 on_match: Optional[Callable] = None
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Chains many tracks at once through a stack {frame: (n, 3) [row,
    col, class]}: in each frame (in the dict's order) every track moves to
    the nearest coordinate within ``rmax`` of its position (one
    :func:`native.knn` query for all tracks), or holds its position and may
    resume in a later frame. ``on_match(track, frame, row) -> bool``
    accepts or refuses a match (a refused one holds the position too).
    Returns one (rows (m, width), frames (m,)) pair per start point."""
    starts = np.asarray(starts, float)
    flows: List[List[np.ndarray]] = [[] for _ in range(len(starts))]
    frames: List[List[int]] = [[] for _ in range(len(starts))]
    cur = starts.copy()
    width = 3
    for k, c in coord_class_dict.items():
        c = np.asarray(c, float)
        if len(c) == 0:
            continue
        width = c.shape[-1]
        d, idx = knn(c[:, :2], cur, 1, rmax)
        d, idx = d[:, 0], idx[:, 0]
        for i in np.nonzero(np.isfinite(d))[0]:
            row = c[idx[i]]
            if on_match is None or on_match(int(i), k, row):
                flows[i].append(row)
                frames[i].append(k)
                cur[i] = row[:2]
    return [(np.asarray(f, float).reshape(len(f), width), np.asarray(fr))
            for f, fr in zip(flows, frames)]


class subimg_trajectories:
    """Trajectories of the atoms of a stack's first frame, with the
    ``window_size`` window around every tracked position (built on
    :func:`chain_tracks`). A match whose window leaves the image is
    refused, and the track holds its position."""

    def __init__(self, imgdata: np.ndarray,
                 coord_class_dict: Dict[int, np.ndarray],
                 window_size: int, min_length: int = 0,
                 rmax: int = 10) -> None:
        self.imgdata = imgdata
        self.coord_class_dict = coord_class_dict
        self.r = window_size
        self.min_length = min_length
        self.rmax = rmax

    def _crop(self, frame: int, row: np.ndarray) -> Optional[np.ndarray]:
        half = self.r // 2
        cx, cy = int(np.around(row[0])), int(np.around(row[1]))
        crop = self.imgdata[frame][cx - half:cx + half, cy - half:cy + half]
        return crop if crop.shape[:2] == (self.r, self.r) else None

    def _track(self, starts: np.ndarray
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        crops: List[List[np.ndarray]] = [[] for _ in range(len(starts))]

        def accept(i, frame, row):
            crop = self._crop(frame, row)
            if crop is None:
                return False
            crops[i].append(crop)
            return True

        tracks = chain_tracks(self.coord_class_dict, starts, self.rmax,
                              on_match=accept)
        return [(flow, frames, np.asarray(cr))
                for (flow, frames), cr in zip(tracks, crops)]

    def get_trajectory(self, start_coord: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, frames, windows) of the track from ``start_coord``."""
        return self._track(np.asarray(start_coord, float)[None, :])[0]

    def get_all_trajectories(self) -> Tuple[List[np.ndarray],
                                            List[np.ndarray],
                                            List[np.ndarray]]:
        """(rows, frames, windows) lists of the tracks from the first
        frame's coordinates that are longer than ``min_length``."""
        first = next(iter(self.coord_class_dict.values()))
        out = [t for t in self._track(first[:, :2])
               if len(t[0]) > self.min_length]
        return ([f for f, _, _ in out], [fr for _, fr, _ in out],
                [s for _, _, s in out])


def get_intensities_(coordinates: np.ndarray, img: np.ndarray, r: int = 3
                     ) -> np.ndarray:
    """Mean intensity of the r x r window around each coordinate (JAX
    `coords.py:149-172`), all atoms at once from a summed-area table;
    windows are clipped to the image, and one with no pixel inside it is
    NaN."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img.mean(-1)
    H, W = img.shape
    sat = np.zeros((H + 1, W + 1))
    np.cumsum(np.cumsum(img, axis=0), axis=1, out=sat[1:, 1:])
    lo = np.around(np.asarray(coordinates)[:, :2]).astype(np.int64) - r // 2
    hi = lo + r                       # the window spans [lo, lo + r)
    x0, x1 = np.clip(lo[:, 0], 0, H), np.clip(hi[:, 0], 0, H)
    y0, y1 = np.clip(lo[:, 1], 0, W), np.clip(hi[:, 1], 0, W)
    sums = sat[x1, y1] - sat[x0, y1] - sat[x1, y0] + sat[x0, y0]
    counts = (x1 - x0) * (y1 - y0)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / counts
    return np.where(counts > 0, means, np.nan)


def get_intensities(coordinates_all: Dict[int, np.ndarray],
                    nn_input: np.ndarray, r: int = 3) -> List[np.ndarray]:
    """:func:`get_intensities_` of each frame of a stack (JAX
    `coords.py:175-179`)."""
    return [get_intensities_(coord, nn_input[k], r)
            for k, coord in coordinates_all.items()]


def compare_coordinates(coordinates1: np.ndarray, coordinates2: np.ndarray,
                        d_max: float, plot_results: bool = False,
                        **kwargs) -> Tuple[np.ndarray, ...]:
    """Each coordinate of set 1 paired with its nearest in set 2 (one
    :func:`native.knn` query), the pairs closer than ``d_max`` kept:
    (set 1's kept, their partners, their distances) (JAX
    `coords.py:182-203`). ``plot_results`` is not ported (ROADMAP #19)."""
    if plot_results:
        raise NotImplementedError(
            "plotting the comparison is not ported yet (ROADMAP #19)")
    coordinates1 = np.asarray(coordinates1, float)
    coordinates2 = np.asarray(coordinates2, float)
    dist, idx = knn(coordinates2, coordinates1, 1)
    dist, idx = dist[:, 0], idx[:, 0]
    keep = dist < d_max
    return coordinates1[keep], coordinates2[idx[keep]], dist[keep]


def remove_edge_coord(coordinates: np.ndarray, dim: Tuple[int, int],
                      dist_edge: int) -> np.ndarray:
    """The coordinates at least ``dist_edge`` from the edges of an image
    of ``dim`` (h, w) (JAX `coords.py:360-367`; rows against w and
    columns against h, as there)."""
    h, w = dim
    c = coordinates
    bad = ((c[:, 0] > w - dist_edge) | (c[:, 0] < dist_edge) |
           (c[:, 1] > h - dist_edge) | (c[:, 1] < dist_edge))
    return coordinates[~bad]


def get_lengthscale_constraints(grid: np.ndarray) -> List[List[float]]:
    """GP lengthscale interval constraints [lower, upper] from a grid of
    pixel indices (`atomai_tpu/utils/coords.py:370-374`)."""
    cmax = np.amax(grid, axis=0) // 2 + 1
    cmin = np.ones(grid.shape[-1])
    return [cmin.tolist(), cmax.tolist()]
