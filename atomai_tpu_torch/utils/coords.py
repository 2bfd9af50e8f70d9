"""Atoms from masks, pixel-coordinate grids of the rVAE, nearest-neighbour
distances and bond maps, atom-position refinement, the clustering of an
ensemble's coordinates and the tracking of atoms through a stack
(counterpart of `atomai_tpu/utils/coords.py`).

:func:`find_com` runs the connected-component labeller of
``csrc/cc_label.cu`` on the card (its plain version on the CPU); the
neighbour queries run the host's grid hash (:mod:`..native`)."""

import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import profiling
from ..core.device import resolve_device
from ..native import ball_query, dbscan, knn
from ..ops.cc_label import blob_centers
from ..ops.peakfit import refine_peaks


def as_device_tensor(data: Union[np.ndarray, torch.Tensor],
                     device: Union[str, torch.device],
                     dtype=np.float32) -> torch.Tensor:
    """A tensor stays on its device; numpy data goes to ``device``
    (``resolve_device``: a CUDA device raises where torch sees none)."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(data, dtype)).to(
        resolve_device(device))


def find_com(image_data: Union[np.ndarray, torch.Tensor],
             max_blobs: Optional[int] = None,
             device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Centres of mass (N, 2) float32 [row, col] of the 4-connected
    components of ``image_data > 0`` (H, W), in scipy's label order (the
    raster order of each component's first pixel): one launch of the
    labeller with its fused sums on the card, the plain version on the
    CPU. A tensor is labelled on its device, numpy data on ``device``.
    The means are exact int64 sums divided in float64 and rounded once
    (the JAX package divides float32 sums: within one float32 ulp).
    ``max_blobs`` (the JAX package's padding bound) is not needed."""
    mask = as_device_tensor(image_data, device) > 0
    coords, _ = blob_centers(mask)
    return coords.cpu().numpy()


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


def get_nn_distances_(coordinates: np.ndarray, nn: int = 2,
                      upper_bound: Optional[float] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Distances (m, nn) from each atom of one frame to its ``nn`` nearest
    neighbours, and the atoms with those neighbours (m, nn + 1, width),
    for the atoms whose ``nn`` neighbours all lie within ``upper_bound``
    (included); one :func:`native.knn` query."""
    d, nn_idx = knn(coordinates[:, :2], coordinates[:, :2], nn + 1,
                    upper_bound)
    hit = ~np.isinf(d).any(axis=1)
    return d[hit, 1:], coordinates[nn_idx[hit]]


def get_nn_distances(coordinates: Union[Dict[int, np.ndarray], np.ndarray],
                     nn: int = 2, upper_bound: Optional[float] = None
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """:func:`get_nn_distances_` of each frame of {frame: (n, 3)} (or of
    one array): (distances, atom groups), one a frame."""
    if isinstance(coordinates, np.ndarray):
        coordinates = {0: coordinates}
    distances_all, atom_pairs_all = [], []
    for coord in coordinates.values():
        distances, atom_pairs = get_nn_distances_(coord, nn, upper_bound)
        distances_all.append(distances)
        atom_pairs_all.append(atom_pairs)
    return distances_all, atom_pairs_all


def gaussian_2d(xy, amp, xo, yo, sigma_x, sigma_y, theta, offset
                ) -> np.ndarray:
    """A rotated anisotropic 2D Gaussian on the grid ``xy`` = (x, y),
    flattened: ``offset + amp * exp(-(u²/σx² + v²/σy²) / 2)`` with (u, v)
    the offsets from (xo, yo) rotated by ``theta``."""
    x, y = xy
    dx, dy = x - xo, y - yo
    ct, st = np.cos(theta), np.sin(theta)
    u = dx * ct - dy * st
    v = dx * st + dy * ct
    g = offset + amp * np.exp(
        -0.5 * ((u / sigma_x) ** 2 + (v / sigma_y) ** 2))
    return g.flatten()


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
    population variance), in ascending label order. Only the noise label
    -1 is left out (original atomai drops the first label whether or not
    it is noise); with no coordinates at all the result is empty.

    One grouped reduction instead of a pass over the points per cluster:
    the clustered rows are sorted by label, each cluster is a slice of
    the sorted rows, and ``np.add.reduceat`` over the slices gives the
    sums, then (after subtracting each cluster's mean, as ``np.var``
    does) the sums of squares. The object array is built as
    ``np.array(list_of_clusters, dtype=object)``, so clusters all of one
    size make it 3-D."""
    with profiling.span("cluster.coord"):
        coordinates_all = np.concatenate(
            [coord_class_dict[k] for k in range(len(coord_class_dict))])
        if len(coordinates_all) == 0:
            empty2 = np.empty((0, 2), dtype=float)
            return np.array([], dtype=object), empty2, empty2
        with profiling.span("cluster.dbscan"):
            labels = dbscan(coordinates_all[:, :2], eps, min_samples)
        kept = np.flatnonzero(labels >= 0)
        if not len(kept):       # all noise: moments of shape (0,)
            return np.array([], dtype=object), np.array([]), np.array([])
        # stable, so each cluster's rows keep their order in the input,
        # the order np.where(labels == label) gives them
        order = kept[np.argsort(labels[kept], kind="stable")]
        rows = coordinates_all[order]
        _, starts, counts = np.unique(labels[order], return_index=True,
                                      return_counts=True)
        xy = rows[:, :2]
        n = counts[:, None].astype(xy.dtype)    # float32 stays float32
        mean = np.add.reduceat(xy, starts, axis=0) / n
        dev = xy - np.repeat(mean, counts, axis=0)
        var = np.add.reduceat(dev * dev, starts, axis=0) / n
        clusters = [rows[a:b] for a, b in zip(starts.tolist(),
                                              (starts + counts).tolist())]
        return np.array(clusters, dtype=object), mean, var


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
    `coords.py:182-203`). ``plot_results`` scatters the kept ones over the
    image ``expdata`` (a keyword, required then), coloured by distance
    (``fsize``; matplotlib is imported then)."""
    coordinates1 = np.asarray(coordinates1, float)
    coordinates2 = np.asarray(coordinates2, float)
    dist, idx = knn(coordinates2, coordinates1, 1)
    dist, idx = dist[:, 0], idx[:, 0]
    keep = dist < d_max
    coordinates1_, delta_r = coordinates1[keep], dist[keep]
    if plot_results:
        from .viz import plot_coordinates_comparison
        plot_coordinates_comparison(coordinates1_, delta_r,
                                    kwargs.get("expdata"),
                                    kwargs.get("fsize", 20))
    return coordinates1_, coordinates2[idx[keep]], delta_r


def find_coord_clusters(coord_class_dict_1: Dict[int, np.ndarray],
                        coord_class_dict_2: Dict[int, np.ndarray],
                        rmax: int) -> Tuple[np.ndarray, np.ndarray, List]:
    """For each atom of frame 0 of ``coord_class_dict_1``, the rows of all
    frames of ``coord_class_dict_2`` within ``rmax`` of it (one
    :func:`native.ball_query` for all of them, rows in stack order): (their
    mean [row, col], their standard deviation, the rows)."""
    coordinates_all = np.concatenate(
        [coord_class_dict_2[k] for k in range(len(coord_class_dict_2))])
    centers = np.asarray(coord_class_dict_1[0])[:, :2]
    clusters, clusters_mean, clusters_std = [], [], []
    for idx in ball_query(coordinates_all[:, :2], centers, rmax):
        cl = coordinates_all[idx]
        clusters_mean.append(cl[:, :2].mean(axis=0))
        clusters_std.append(cl[:, :2].std(axis=0))
        clusters.append(cl)
    return np.array(clusters_mean), np.array(clusters_std), clusters


def map_bonds(coordinates: Dict[int, np.ndarray], nn: int = 2,
              upper_bound: Optional[float] = None,
              distance_ideal: Optional[float] = None,
              plot_results: bool = True, **kwargs) -> np.ndarray:
    """The distances of every frame's atoms to their ``nn`` nearest
    neighbours (:func:`get_nn_distances`), concatenated. With
    ``plot_results``, each frame's bonds are drawn coloured by their
    deviation from ``distance_ideal`` (default: the mean distance) by
    :func:`viz.plot_lattice_bonds` (``savedir``, ``h``, ``w``). Without
    it nothing is drawn and matplotlib is not imported (the JAX package
    then writes ``frame_<i>.png`` into the working directory)."""
    distances_all, atom_pairs_all = get_nn_distances(
        coordinates, nn, upper_bound)
    if plot_results:
        from .viz import plot_lattice_bonds
        if distance_ideal is None:
            distance_ideal = np.mean(np.concatenate(distances_all))
        for i, (dist, at) in enumerate(zip(distances_all, atom_pairs_all)):
            plot_lattice_bonds(dist, at, distance_ideal, i, True, **kwargs)
    return np.concatenate(distances_all)


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
