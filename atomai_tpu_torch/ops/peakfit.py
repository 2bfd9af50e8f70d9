"""Batched 2D-Gaussian peak refinement (Levenberg–Marquardt), on the
device.

Counterpart of `atomai_tpu/ops/peakfit.py:21-105`: every atom's window is
fitted at once. Windows are cut by index arithmetic (a gather), the
Jacobian of the 7-parameter Gaussian (`peakfit.py:21-33`) is analytic, and
each of exactly 25 iterations solves the (N, 7, 7) damped normal systems
in one batched ``torch.linalg.solve_ex``, with the JAX package's damping
rule (lambda halves on an improvement and doubles otherwise, starting at
1e-2). A fit is kept only if its window lies inside the image and its
centre moved less than 3 px from the window's centre; otherwise the input
coordinate is returned. The JAX package's power-of-two padding of the atom
count (`atomai_tpu/utils/coords.py:136-142`) only saves jit recompiles and
is not ported.

The fit runs in float64 (the JAX package's in float32). The angle of a
nearly round atom is not identifiable, so its last iterations wander along
a flat valley, and 25 fixed iterations amplify float32 rounding there into
centres that move by up to ~7e-3 px with the order of a sum (measured on
about 1% of lattice atoms, and a fit at the edge of a window that lands on
either side of the 3 px rule). In float64 the result no longer depends on
the device: it matches the JAX package's golden fixture to 3e-5 px.
"""

from typing import Optional, Tuple

import torch

_N_ITER = 25
_LAM0 = 1e-2


def _gaussian_terms(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """The model g (N, P) and the pieces its derivatives reuse, for
    parameters p (N, 7) = [amp, xo, yo, sigma_x, sigma_y, theta, offset]
    at the pixel coordinates x, y (P,)."""
    amp, xo, yo, sx, sy, th, off = (p[:, i:i + 1] for i in range(7))
    cos, sin, sin2 = torch.cos(th), torch.sin(th), torch.sin(2 * th)
    a = cos ** 2 / (2 * sx ** 2) + sin ** 2 / (2 * sy ** 2)
    b = -sin2 / (4 * sx ** 2) + sin2 / (4 * sy ** 2)
    c = sin ** 2 / (2 * sx ** 2) + cos ** 2 / (2 * sy ** 2)
    dx, dy = x - xo, y - yo
    e = torch.exp(-(a * dx ** 2 + 2 * b * dx * dy + c * dy ** 2))
    return off + amp * e, e, a, b, c, dx, dy


def gaussian_2d(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
    """The rotated 2D Gaussian of each parameter row at (x, y)."""
    return _gaussian_terms(p, x, y)[0]


def _residual_and_jacobian(p, x, y, target):
    g, e, a, b, c, dx, dy = _gaussian_terms(p, x, y)
    amp, sx, sy, th = p[:, 0:1], p[:, 3:4], p[:, 4:5], p[:, 5:6]
    ae = amp * e
    cos, sin = torch.cos(th), torch.sin(th)
    sin2, cos2 = torch.sin(2 * th), torch.cos(2 * th)

    def dq(da, db, dc):      # derivative of the exponent's quadratic form
        return da * dx ** 2 + 2 * db * dx * dy + dc * dy ** 2
    sx3, sy3 = sx ** 3, sy ** 3
    d_theta = 0.5 * (1 / sy ** 2 - 1 / sx ** 2)
    J = torch.stack([
        e,
        ae * (2 * a * dx + 2 * b * dy),
        ae * (2 * b * dx + 2 * c * dy),
        -ae * dq(-cos ** 2 / sx3, sin2 / (2 * sx3), -sin ** 2 / sx3),
        -ae * dq(-sin ** 2 / sy3, -sin2 / (2 * sy3), -cos ** 2 / sy3),
        -ae * dq(sin2 * d_theta, cos2 * d_theta, -sin2 * d_theta),
        torch.ones_like(e)], dim=-1)
    return g - target, J


def _lm_fit(windows: torch.Tensor, d: int, n_iter: int = _N_ITER
            ) -> torch.Tensor:
    """LM fits of (N, 2d, 2d) windows; the (N, 7) parameters."""
    n, size = windows.shape[0], windows.shape[1]
    grid = torch.arange(size, dtype=windows.dtype, device=windows.device)
    x = grid[:, None].expand(size, size).reshape(-1)
    y = grid[None, :].expand(size, size).reshape(-1)
    target = windows.reshape(n, -1)
    p = torch.zeros(n, 7, dtype=windows.dtype, device=windows.device)
    p[:, 0] = windows[:, d, d]
    p[:, 1:3] = float(d)
    p[:, 3:5] = 1.0
    lam = torch.full((n, 1), _LAM0, dtype=windows.dtype,
                     device=windows.device)
    eye = torch.eye(7, dtype=windows.dtype, device=windows.device)
    for _ in range(n_iter):
        res, J = _residual_and_jacobian(p, x, y, target)
        JtJ = J.transpose(1, 2) @ J
        grad = (J.transpose(1, 2) @ res[..., None])[..., 0]
        A = JtJ + lam[..., None] * (torch.diagonal(JtJ, dim1=1, dim2=2)
                                    + 1e-8)[:, None, :] * eye
        dp = torch.linalg.solve_ex(A, grad)[0]
        p_new = p - dp
        r_new = gaussian_2d(p_new, x, y) - target
        improved = ((r_new * r_new).sum(1) < (res * res).sum(1))[:, None]
        p = torch.where(improved, p_new, p)
        lam = torch.where(improved, lam * 0.5, lam * 2.0)
    return p


def refine_peaks(imgdata: torch.Tensor, coords: torch.Tensor, d: int,
                 frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Refined (N, 2) float32 [row, col] coordinates.

    Args:
        imgdata: (H, W) image, or (F, H, W) frames with ``frames``.
        coords: (N, 2) initial [row, col] coordinates.
        d: half-side of the square fitting window.
        frames: (N,) frame index of each coordinate into a stack.
    """
    if imgdata.ndim == 2:
        imgdata = imgdata[None]
    n_frames, H, W = imgdata.shape
    coords = coords.float()
    if len(coords) == 0:        # no atoms: nothing to fit
        return coords.reshape(0, 2)
    if frames is None:
        frames = torch.zeros(len(coords), dtype=torch.long,
                             device=coords.device)
    size = 2 * d
    c = torch.round(coords).long()
    in_bounds = ((c[:, 0] - d >= 0) & (c[:, 1] - d >= 0) &
                 (c[:, 0] + d <= H) & (c[:, 1] + d <= W))
    x0 = torch.clamp(c[:, 0] - d, min=0, max=max(H - size, 0))
    y0 = torch.clamp(c[:, 1] - d, min=0, max=max(W - size, 0))
    r = torch.arange(size, device=coords.device)
    rows = (x0[:, None] + r).clamp(max=H - 1)
    cols = (y0[:, None] + r).clamp(max=W - 1)
    windows = imgdata[frames[:, None, None], rows[:, :, None],
                      cols[:, None, :]]                  # (N, size, size)
    center = _lm_fit(windows.double(), d)[:, 1:3]
    ok = in_bounds & (torch.linalg.vector_norm(center - d, dim=1) < 3.0)
    refined = (center + torch.round(coords).double() - d).float()
    return torch.where(ok[:, None], refined, coords)
