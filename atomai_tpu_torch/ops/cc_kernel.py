"""Connected-component labels: the CUDA kernel and its plain version.

Counterpart of `atomai_tpu/ops/pallas_cc.py:27-100` (the TPU kernel and
its dispatcher). Contract, as in the JAX package: for a binary (H, W)
mask, 4-neighbour connectivity, int32 labels where every foreground pixel
holds the minimal flat index of its component and every background pixel
holds H*W.

- :func:`label_components` dispatches on the tensor's device: the plain
  version for a CPU tensor, the kernel (``csrc/cc_label.cu``) for a CUDA
  tensor, an error for anything else.
- :func:`label_components_reference` is the plain version: the
  min-propagation + pointer-jumping loop of
  `atomai_tpu/ops/cc_label.py:52-92` in torch, run until nothing changes
  (the JAX loops stop silently after ``max_iters=4096``; neither version
  here has a cap).
"""

import ctypes

import torch

from . import _build

# kernel launches since import (or since a caller reset it); the wrapper
# adds one per call that launches the kernel, and only there
LAUNCHES = 0

_SOURCE = "cc_label.cu"
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        lib.cc_label_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.cc_label_launch.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Builds and loads the kernel library now (otherwise at first use)."""
    _library()


def _check_mask(mask: torch.Tensor) -> None:
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2D (H, W), got shape "
                         f"{tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    if mask.shape[0] * mask.shape[1] >= 2 ** 31:
        raise ValueError("H*W must stay below 2^31 (int32 flat labels)")


def label_components_cuda(mask: torch.Tensor) -> torch.Tensor:
    """Runs the CUDA kernel on a CUDA mask; returns int32 labels."""
    global LAUNCHES
    _check_mask(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"the kernel takes a CUDA tensor, got "
                         f"{mask.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    lib = _library()
    H, W = mask.shape
    labels = torch.empty((H, W), dtype=torch.int32, device=mask.device)
    if H * W == 0:
        return labels
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.cc_label_launch(mask.data_ptr(), labels.data_ptr(),
                                  H, W, stream)
    if err != 0:
        raise RuntimeError("cc_label kernel launch failed: "
                           + lib.cc_error_string(err).decode())
    LAUNCHES += 1
    return labels


def label_components_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain torch labeller on any device: 4-neighbour min-propagation with
    two pointer-jumping steps per sweep, until a fixpoint."""
    _check_mask(mask)
    H, W = mask.shape
    big = H * W
    fg = mask != 0
    idx = torch.arange(big, dtype=torch.int32, device=mask.device)
    lab = torch.where(fg, idx.view(H, W), big)
    while True:
        new = lab.clone()
        torch.minimum(new[:-1], lab[1:], out=new[:-1])
        torch.minimum(new[1:], lab[:-1], out=new[1:])
        torch.minimum(new[:, :-1], lab[:, 1:], out=new[:, :-1])
        torch.minimum(new[:, 1:], lab[:, :-1], out=new[:, 1:])
        new = torch.where(fg, new, big)
        # pointer jumping x2: label <- min(label, label[label])
        flat_ext = torch.cat([new.reshape(-1), new.new_full((1,), big)])
        flat = flat_ext[:-1]
        flat = torch.minimum(flat, flat_ext.index_select(0, flat))
        flat = torch.minimum(flat, flat_ext.index_select(0, flat))
        new = torch.where(fg, flat.view(H, W), big)
        if torch.equal(new, lab):
            return lab
        lab = new


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Labels a (H, W) bool/uint8 mask: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if mask.device.type == "cpu":
        return label_components_reference(mask)
    if mask.device.type == "cuda":
        return label_components_cuda(mask.contiguous())
    raise ValueError(f"label_components runs on 'cpu' or 'cuda' tensors, "
                     f"got device {mask.device}")
