"""Pixel-coordinate grids of the rVAE and atom-position refinement
(counterpart of `atomai_tpu/utils/coords.py:51-81, 123-146`)."""

import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
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
