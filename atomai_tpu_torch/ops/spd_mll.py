"""The exact GP's marginal-likelihood terms: a CUDA kernel pair and its plain
version.

For a symmetric positive definite (b, N, N) matrix K (the kernel matrix
with its noise on the diagonal) and (b, N) residuals r = y - mean, the
exact negative MLL needs two terms of each output::

    q = r^T K^-1 r = |L^-1 r|^2          h = sum_i log L_ii = log det K / 2

with L L^T = K. Their gradients have closed forms, with W = L^-1,
alpha = K^-1 r = W^T (L^-1 r) and K^-1 = W^T W::

    dK = g_h K^-1 / 2 - g_q alpha alpha^T          dr = 2 g_q alpha

- :func:`route` picks the route by what the input shows: ``"kernel"`` for
  a float32 K on a CUDA card with N <= ``MLL_KERNEL_MAX_N`` (the crossover
  of a card sweep of both routes), ``"library"`` otherwise (the caller's
  ``torch.linalg.cholesky_ex`` and a triangular solve, differentiated by
  autograd: cuSOLVER and cuBLAS on a card, LAPACK on the CPU).
- :func:`mll_terms` is the kernel route: :class:`ExactMLLTerms`, whose
  forward is ``spd_mll_forward`` of ``csrc/spd_mll.cu`` and whose backward
  is ``spd_mll_backward``.
- :func:`mll_factor_reference` and :func:`mll_grad_reference` are the
  kernels' algorithm in plain torch, in the input's dtype: the Cholesky
  factor of the augmented matrix ``[[K, r], [r^T, 1]]``, padded with an
  identity to a multiple of the tile, in tile columns of ``MLL_TILE``, with
  the inverse ``W`` of the factor swept along in the same steps; then the
  closed-form gradient from ``W`` alone.

The augmented factor is ``[[L, 0], [v^T, 1]]`` with v = L^-1 r (its last
pivot, and those of the identity, are set to 1 rather than computed), so
that the factor's last row is the solve; its inverse is ``[[W, 0],
[-alpha^T, 1]]``, so that the inverse's last row is -alpha. A pivot of K
that is not positive (or is NaN) marks the output failed: its q, h, L and
W are NaN, as ``torch.linalg.cholesky_ex`` and a NaN factor give on the
library route, with no host sync. Neither the kernels nor their plain
version replace a TPU kernel: the JAX package leaves the factor to XLA.
:func:`mll_flops` counts their work for the bounds of ``chip_smoke.py``.
"""

import ctypes
from typing import Optional, Tuple

import torch

from ..core import profiling
from . import _build

# tile width of the kernels' steps (``kTile`` of ``csrc/spd_mll.cu``; a
# card sweep of 32 and 64 chose it)
MLL_TILE = 32
# the largest N on the kernel route: a card sweep of both routes' forward
# and backward (``chip_smoke.py``'s spd_mll phase, N = 64 ... 4,096) found
# the kernels faster at every size up to 3,072 at one output (5.7 against
# 7.1 ms) and at four (23.5 against 33.2 ms), and the library faster at
# 4,096 at one output (12.7 against 12.0 ms), where the kernels' trailing
# updates outgrow their chain
MLL_KERNEL_MAX_N = 3072

_SOURCE = "spd_mll.cu"
_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        lib.spd_mll_forward.argtypes = [_P] * 8 + [_I, _I, _P]
        lib.spd_mll_forward.restype = _I
        lib.spd_mll_backward.argtypes = [_P] * 5 + [_I, _I, _P]
        lib.spd_mll_backward.restype = _I
        lib.spd_mll_error_string.argtypes = [_I]
        lib.spd_mll_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Builds and loads the kernel library now (otherwise at first use)."""
    _library()


def route(device: torch.device, dtype: torch.dtype, n: int) -> str:
    """``"kernel"`` or ``"library"`` for an (n, n) K of ``dtype`` on
    ``device``."""
    return "kernel" if device.type == "cuda" and dtype == torch.float32 \
        and n <= MLL_KERNEL_MAX_N else "library"


def padded_size(n: int, tile: Optional[int] = None) -> int:
    """Rows of the augmented matrix of an (n, n) K: n + 1 padded up to a
    multiple of ``tile`` (``MLL_TILE``)."""
    tile = tile or MLL_TILE
    return -(-(n + 1) // tile) * tile


def mll_flops(n: int) -> Tuple[int, int]:
    """Multiply-add FLOPs (2 a multiply-add) of the forward with the inverse
    swept along, and of the backward, at the padded size P: the factor P^3/3,
    the inverse P^3/3; the backward's K^-1 = W^T W is n^3/3 (its lower
    half, each product summed from the diagonal tile down)."""
    p = padded_size(n)
    return 2 * p ** 3 // 3, n ** 3 // 3


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"spd_mll {what} failed: "
                           + _library().spd_mll_error_string(err).decode())


def _check(K: torch.Tensor, r: torch.Tensor) -> Tuple[int, int]:
    if K.ndim != 3 or K.shape[1] != K.shape[2] or r.shape != K.shape[:2]:
        raise ValueError(f"K must be (b, N, N) and r (b, N), got "
                         f"{tuple(K.shape)} and {tuple(r.shape)}")
    for t in (K, r):
        if t.device.type != "cuda" or t.device != K.device:
            raise ValueError(f"the kernels take CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32, got {t.dtype}")
    return K.shape[0], K.shape[-1]


def mll_forward_cuda(K: torch.Tensor, r: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """Launches the forward kernel; returns (q, h, A, W): q and h (b,), A
    the (b, P, P) augmented factor (L = A[:, :N, :N], v = A[:, N, :N]) and
    W its inverse. Counts ``spd_mll.forward_launches``."""
    b, n = _check(K, r)
    K, r = K.contiguous(), r.contiguous()
    p = padded_size(n)
    dev = K.device
    A = torch.empty((b, p, p), dtype=torch.float32, device=dev)
    W = torch.empty((b, p, p), dtype=torch.float32, device=dev)
    Ld = torch.empty((b, p, MLL_TILE), dtype=torch.float32, device=dev)
    q = torch.empty(b, dtype=torch.float32, device=dev)
    h = torch.empty(b, dtype=torch.float32, device=dev)
    sync = torch.empty(1 + b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().spd_mll_forward(
            K.data_ptr(), r.data_ptr(), A.data_ptr(), W.data_ptr(),
            Ld.data_ptr(), q.data_ptr(), h.data_ptr(), sync.data_ptr(), b, n,
            stream)
    _raise_on(err, "forward launch")
    profiling.count("spd_mll.forward_launches")
    return q, h, A, W


def mll_backward_cuda(W: torch.Tensor, n: int, g_q: torch.Tensor,
                      g_h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the backward kernel on the forward's W; returns dK (b, n, n),
    full and symmetric, and dr (b, n). Counts
    ``spd_mll.backward_launches``."""
    b, p = W.shape[0], W.shape[-1]
    if p != padded_size(n):
        raise ValueError(f"W of {p} rows is not the padded inverse of n={n}")
    dev = W.device
    g_q = g_q.to(torch.float32).contiguous()
    g_h = g_h.to(torch.float32).contiguous()
    dK = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    dr = torch.empty((b, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().spd_mll_backward(
            W.data_ptr(), g_q.data_ptr(), g_h.data_ptr(), dK.data_ptr(),
            dr.data_ptr(), b, n, stream)
    _raise_on(err, "backward launch")
    profiling.count("spd_mll.backward_launches")
    return dK, dr


# the launchers of ExactMLLTerms, which the CPU tests replace by the plain
# versions
def _forward(K, r):
    q, h, _, W = mll_forward_cuda(K, r)
    return q, h, W


def _backward(W, n, g_q, g_h):
    return mll_backward_cuda(W, n, g_q, g_h)


class ExactMLLTerms(torch.autograd.Function):
    """(q, h) of (K, r) by the forward kernel; the backward kernel's
    closed-form (dK, dr) from the saved inverse W alone."""

    @staticmethod
    def forward(ctx, K, r):
        q, h, W = _forward(K, r)
        ctx.save_for_backward(W)
        ctx.n = K.shape[-1]
        return q, h

    @staticmethod
    def backward(ctx, g_q, g_h):
        W, = ctx.saved_tensors
        g_q = torch.zeros_like(W[:, 0, 0]) if g_q is None else g_q
        g_h = torch.zeros_like(W[:, 0, 0]) if g_h is None else g_h
        return _backward(W, ctx.n, g_q, g_h)


def mll_terms(K: torch.Tensor, r: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, h), each (b,), of a (b, N, N) K and (b, N) r on the kernel
    route; differentiable."""
    return ExactMLLTerms.apply(K, r)


# ------------------------------------------------------------ plain version

def augmented(K: torch.Tensor, r: torch.Tensor, tile: Optional[int] = None
              ) -> torch.Tensor:
    """(b, P, P): K's lower triangle, r as row N, 1 at (N, N), an identity
    on the padding, zeros above the diagonal."""
    b, n = r.shape
    p = padded_size(n, tile)
    A = K.new_zeros((b, p, p))
    A[:, :n, :n] = torch.tril(K)
    A[:, n, :n] = r
    pad = torch.arange(n, p, device=K.device)
    A[:, pad, pad] = 1
    return A


def _tile_factor(A: torch.Tensor, first: int, n: int):
    """Lower Cholesky factor of a (b, T, T) diagonal tile whose first row is
    row ``first`` of the augmented matrix, column by column; pivots at rows
    >= n are 1. Returns (factor, its inverse, failed (b,))."""
    A = A.clone()
    T = A.shape[-1]
    failed = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    for j in range(T):
        if first + j < n:
            d = A[:, j, j]
            failed |= ~(d > 0)
            piv = torch.sqrt(d)
        else:
            piv = torch.ones_like(A[:, j, j])
        A[:, j, j] = piv
        col = A[:, j + 1:, j] / piv[:, None]
        A[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    L = torch.tril(A)
    eye = torch.eye(T, dtype=A.dtype, device=A.device).expand_as(L)
    return L, torch.linalg.solve_triangular(L, eye, upper=False), failed


def mll_factor_reference(K: torch.Tensor, r: torch.Tensor,
                         tile: Optional[int] = None):
    """The forward kernel's algorithm: (q, h, A, W) as
    :func:`mll_forward_cuda` returns them, in K's dtype. Step k factors the
    diagonal tile k and inverts it (D), turns tile column k into L (times
    D^T) and tile row k of the inverse into W (D times what the earlier
    steps left there), then takes both from the trailing tiles."""
    b, n = r.shape
    tile = tile or MLL_TILE
    A = augmented(K, r, tile)
    p = A.shape[-1]
    W = torch.zeros_like(A)
    failed = torch.zeros(b, dtype=torch.bool, device=K.device)
    for k in range(p // tile):
        s, lo = slice(k * tile, (k + 1) * tile), (k + 1) * tile
        L_kk, D, f = _tile_factor(A[:, s, s], k * tile, n)
        failed |= f
        A[:, s, s] = L_kk
        A[:, lo:, s] = A[:, lo:, s] @ D.mT
        panel = A[:, lo:, s]
        A[:, lo:, lo:] -= panel @ panel.mT
        W[:, s, :k * tile] = D @ W[:, s, :k * tile]
        W[:, s, s] = D
        W[:, lo:, :lo] -= panel @ W[:, s, :lo]
    A = torch.tril(A)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    A = torch.where(failed[:, None, None], nan, A)
    W = torch.where(failed[:, None, None], nan, W)
    v = A[:, n, :n]
    q = torch.sum(v * v, -1)
    h = torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)[:, :n]), -1)
    return q, h, A, W


def mll_grad_reference(W: torch.Tensor, n: int, g_q: torch.Tensor,
                       g_h: torch.Tensor):
    """The backward kernel's algorithm: (dK, dr) from the forward's W, with
    alpha = -W[:, n, :n] and K^-1 = W^T W over W's first n rows."""
    Wn = W[:, :n, :n]
    alpha = -W[:, n, :n]
    kinv = Wn.mT @ Wn
    dK = 0.5 * g_h[:, None, None] * kinv \
        - g_q[:, None, None] * alpha[:, :, None] * alpha[:, None, :]
    return dK, 2 * g_q[:, None] * alpha
