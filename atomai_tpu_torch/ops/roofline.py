"""The least time an NVIDIA H100 could take for a kernel's work.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 989 TFLOP/s on bf16 tensor cores and 3.35 TB/s of HBM3.
A bound is the larger of operations over the compute peak and bytes over
the memory rate; the kernels' modules count their own operations and bytes
(``spatial_mlp.spatial_mlp_flops``, ``cc_kernel.cc_label_bytes``).
"""

from typing import Tuple

H100_BF16_FLOPS = 989e12      # FLOP/s, dense bf16 tensor cores
H100_HBM_BYTES = 3.35e12      # bytes/s


def bound_ms(flops: float, nbytes: float) -> float:
    """Milliseconds of ``flops`` bf16 operations and ``nbytes`` of device
    memory traffic at the H100's peaks: the larger of the two times."""
    return bound(flops, nbytes)[0]


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(:func:`bound_ms`, "operations" or "bytes": which of the two sets
    it)."""
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
