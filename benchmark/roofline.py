"""The yardstick: peaks of one NVIDIA H100 and the work a call needs.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power
limit): 989 TFLOP/s on bf16 tensor cores, 3.35 TB/s of HBM3. A copy of the
port's ``ops/roofline.py`` and of ``ops/cc_kernel.cc_label_bytes``, kept
here so that a later change to the program cannot move the yardstick.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

H100_BF16_FLOPS = 989e12      # FLOP/s, dense bf16 tensor cores
H100_HBM_BYTES = 3.35e12      # bytes/s


def cc_label_bytes(H: int, W: int, blobs: int = 0) -> int:
    """Device-memory bytes a labelling of an (H, W) mask with ``blobs``
    components must move: the one-byte mask read once, the int32 labels
    written once and each component's int32 root and int64 count, row sum
    and column sum written once."""
    return H * W * (1 + 4) + blobs * (4 + 3 * 8)


def locator_bytes(frames: int, h: int, w: int, blobs: int) -> int:
    """:func:`cc_label_bytes` of the Locator's one labelling of a stack:
    ``frames`` masks tiled into one image, each followed by a background
    row."""
    return cc_label_bytes(frames * (h + 1), w, blobs)


def net_flops(net: torch.nn.Module, shape, backward: bool) -> int:
    """FLOPs of one forward (and with ``backward`` its backward) of ``net``
    on an input of ``shape``, counted by torch's FlopCounterMode (matrix
    products and convolutions) on meta tensors: nothing is computed."""
    net = net.to("meta")
    net.train(backward)
    x = torch.zeros(shape, device="meta", requires_grad=False)
    with FlopCounterMode(display=False) as counter:
        out = net(x)
        if backward:
            out.sum().backward()
    return int(counter.get_total_flops())
