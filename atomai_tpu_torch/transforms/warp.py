"""Geometric warps by bilinear sampling, on the tensors' device.

Counterpart of `atomai_tpu/transforms/warp.py:7-90`. Every function takes
explicit sample coordinates, so each is held against its JAX counterpart
on the same arrays. The axis-aligned warps run as two interpolation-matrix
products (``Ay @ img @ Ax.T``), batched over any leading dims.
"""

import torch


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Samples ``img`` (H, W) at float coordinates (``ys``, ``xs``, any
    equal shapes) with bilinear interpolation and zeros outside."""
    H, W = img.shape
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1, x1 = y0 + 1, x0 + 1
    wy = ys - y0
    wx = xs - x0

    def at(y, x):
        inb = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        v = img[y.clamp(0, H - 1), x.clamp(0, W - 1)]
        return torch.where(inb, v, torch.zeros_like(v))

    return ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1) +
            wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))


def interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """Bilinear-interpolation matrix A (..., S, n): ``A @ v`` samples a
    length-n signal at the float ``coords`` (..., S), zero outside
    [0, n - 1]."""
    i0 = torch.floor(coords).long()
    w = (coords - i0).unsqueeze(-1)
    cols = torch.arange(n, device=coords.device)
    in0 = ((i0 >= 0) & (i0 <= n - 1)).unsqueeze(-1)
    in1 = ((i0 + 1 >= 0) & (i0 + 1 <= n - 1)).unsqueeze(-1)
    m0 = (cols == i0.clamp(0, n - 1).unsqueeze(-1)) & in0
    m1 = (cols == (i0 + 1).clamp(0, n - 1).unsqueeze(-1)) & in1
    return m0 * (1.0 - w) + m1 * w


def separable_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear samples of ``img`` (..., H, W) on the grid ``ys`` x ``xs``
    ((..., S) and (..., T)): an axis-aligned warp, (..., S, T)."""
    Ay = interp_matrix(ys, img.shape[-2])
    Ax = interp_matrix(xs, img.shape[-1])
    return Ay @ img @ Ax.transpose(-1, -2)


def separable_sample_nhwc(stack: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """The same warp of a channel-last stack (..., H, W, C) ->
    (..., S, T, C). Label masks go this way and are rounded after it, so
    callers keep it in float32 with TF32 off."""
    Ay = interp_matrix(ys, stack.shape[-3])
    Ax = interp_matrix(xs, stack.shape[-2])
    return torch.einsum("...sh,...hwc,...tw->...stc", Ay, stack, Ax)


def rotate_image(img: torch.Tensor, angle) -> torch.Tensor:
    """Rotates an (H, W) or (H, W, C) image by ``angle`` (radians)
    counter-clockwise about its centre (cv2's positive angle; 90 degrees
    is ``rot90(img, 1)``), sampling the inverse map."""
    H, W = img.shape[0], img.shape[1]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    angle = torch.as_tensor(angle, dtype=torch.float32, device=img.device)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    c, s = torch.cos(angle), torch.sin(angle)
    ys = c * (yy - cy) + s * (xx - cx) + cy
    xs = -s * (yy - cy) + c * (xx - cx) + cx
    if img.ndim == 3:
        return torch.stack([bilinear_sample(img[..., k], ys, xs)
                            for k in range(img.shape[2])], dim=2)
    return bilinear_sample(img, ys, xs)
