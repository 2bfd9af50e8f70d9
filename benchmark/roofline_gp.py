"""The work of a GP posterior draw, and the H100's float64 peak.

Peak (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power
limit): 67 TFLOP/s of float64 on the tensor cores, the rate of cuBLAS's
and cuSOLVER's float64 GEMM, SYRK, TRSM and Cholesky kernels.
"""

H100_FP64_FLOPS = 67e12       # FLOP/s, float64 tensor cores


def draw_flops(n: int, m: int, d: int, samples: int = 1) -> float:
    """Floating-point operations of the linear algebra of one output's
    draw over ``m`` candidates in a ``d``-dimensional embedding, given
    ``n`` training points. The training side: the cross product of the
    kernel matrix (2 n^2 d), its Cholesky factor (n^3 / 3) and the two
    triangular solves of the weights (2 n^2). The candidates: the cross
    products of K(X, Xs) (2 n m d) and K(Xs, Xs) (2 m^2 d), the mean
    K(X, Xs)^T alpha (2 n m), the triangular solve V = L^-1 K(X, Xs)
    (n^2 m), the product V^T V (2 n m^2), the candidates' Cholesky factor
    (m^3 / 3) and L eps for each sample (2 m^2)."""
    train = 2.0 * n * n * d + n ** 3 / 3.0 + 2.0 * n * n
    cand = (2.0 * n * m * d + 2.0 * m * m * d + 2.0 * n * m + n * n * m
            + 2.0 * n * m * m + m ** 3 / 3.0)
    return train + cand + 2.0 * m * m * samples
