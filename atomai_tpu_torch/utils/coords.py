"""Pixel-coordinate grids of the rVAE (counterpart of
`atomai_tpu/utils/coords.py:51-81`)."""

from typing import Tuple, Union

import numpy as np
import torch


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
