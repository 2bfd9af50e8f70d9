"""The work of the rVAE's spatial-MLP kernel pair (``csrc/spatial_mlp.cu``)
a training step, for the kernels' shares of their roofline.

A copy of the port's ``ops/spatial_mlp.py`` ``spatial_mlp_flops`` and
``spatial_mlp_bytes``, kept here so that a later change to the program
cannot move the yardstick. Peaks are ``roofline.py``'s: 989 TFLOP/s of
bf16 and 3.35 TB/s of HBM3 (H100 SXM, dense, 700 W).
"""

from typing import Tuple

import roofline


def spatial_mlp_flops(B: int, n: int, H: int, L: int) -> Tuple[int, int]:
    """Matrix-product FLOPs (2·M·K·N each, M = B·n rows) of the forward
    and of the backward; elementwise work (biases, tanh, column sums) is
    not counted. Forward: h0 (K = 2), L hidden layers, the head. Backward:
    the recomputed h0..hL, the head's dWo and dh, each hidden layer's dW
    and dh, and dWc and dx."""
    M = B * n
    forward = 2 * M * (2 * H + L * H * H + H)
    backward = 2 * M * (2 * H + L * H * H) + 2 * M * (2 * H) \
        + 2 * M * (2 * L * H * H) + 2 * M * (4 * H)
    return forward, backward


def spatial_mlp_bytes(B: int, n: int, H: int, L: int) -> Tuple[int, int]:
    """Device-memory bytes the forward and the backward must move, each
    float32 input read once and each output written once: x, zb and the
    weights in, y out; the backward reads gy too and writes dx, dzb and a
    gradient of every weight."""
    weights = 4 * (3 * H + L * H * H + L * H + H + 1)
    rows = 4 * B * n
    forward = 2 * rows + 4 * B * H + weights + rows
    backward = 2 * rows + 4 * B * H + weights + rows \
        + 2 * rows + 4 * B * H + weights
    return forward, backward


def bound_s(B: int, n: int, H: int, L: int) -> Tuple[float, float]:
    """Seconds of the forward's and the backward's roofline bound: the
    larger of their FLOPs over the bf16 peak and their bytes over the
    memory's."""
    return tuple(max(f / roofline.H100_BF16_FLOPS, b / roofline.H100_HBM_BYTES)
                 for f, b in zip(spatial_mlp_flops(B, n, H, L),
                                 spatial_mlp_bytes(B, n, H, L)))
