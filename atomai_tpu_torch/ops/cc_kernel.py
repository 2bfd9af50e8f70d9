"""Connected-component labels and blob sums: the CUDA kernel and its plain
version.

Counterpart of `atomai_tpu/ops/pallas_cc.py:27-100` (the TPU kernel and
its dispatcher) and of the segment sums that follow it
(`atomai_tpu/ops/cc_label.py:95-122`). Contract, as in the JAX package: for
a binary (H, W) mask, 4-neighbour connectivity, int32 labels where every
foreground pixel holds the minimal flat index of its component and every
background pixel holds H*W.

- :func:`label_components` dispatches on the tensor's device: the plain
  version for a CPU tensor, the kernel (``csrc/cc_label.cu``) for a CUDA
  tensor, an error for anything else.
- :func:`label_components_reference` is the plain version: the
  min-propagation + pointer-jumping loop of
  `atomai_tpu/ops/cc_label.py:52-92` in torch, run until nothing changes
  (the JAX loops stop silently after ``max_iters=4096``; neither version
  here has a cap).
- :func:`blob_sums_cuda` runs the same kernel with the per-component pixel
  counts and row/column sums fused into it (the plain version is
  ``cc_label.blob_sums_reference``).

The kernel labels 32 x 64 tiles in shared memory and merges across tile
borders; ``TILE_H``, ``TILE_W`` and the packing of a tile's partial sums
(``PACK_*``) mirror the constants of ``csrc/cc_label.cu``.
"""

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build

# kernel launches since import (or since a caller reset it); the wrappers
# add one per call that launches the kernel, and only there
LAUNCHES = 0

TILE_H = 32
TILE_W = 64
# a tile holds at most half its pixels as 4-connected components
MAX_TILE_ROOTS = TILE_H * TILE_W // 2
# (shift, bits) of a tile-local component's packed partial sums: pixel
# count, tile-local rows, tile-local columns, band wraps
PACK_COUNT = (0, 12)
PACK_ROWS = (12, 16)
PACK_COLS = (28, 17)
PACK_WRAPS = (45, 16)

_SOURCE = "cc_label.cu"
_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        lib.cc_label_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P,
                                        _P, _P, _P, ctypes.c_longlong, _P]
        lib.cc_label_launch.restype = _I
        lib.cc_error_string.argtypes = [_I]
        lib.cc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Builds and loads the kernel library now (otherwise at first use)."""
    _library()


def tile_count(H: int, W: int) -> int:
    """Number of the kernel's tiles on an (H, W) mask, ragged ones too."""
    return -(-H // TILE_H) * -(-W // TILE_W)


def root_capacity(H: int, W: int) -> int:
    """Most tile-local components an (H, W) mask can have: the length of
    the kernel's root list (a stretch for each tile) and of its blob
    slots."""
    return tile_count(H, W) * MAX_TILE_ROOTS


def cc_label_bytes(H: int, W: int, blobs: int = 0) -> int:
    """Device-memory bytes the labeller must move for an (H, W) mask with
    ``blobs`` components: the one-byte mask read once, the int32 labels
    written once and, with moments, each component's int32 root and int64
    count, row sum and column sum written once."""
    return H * W * (1 + 4) + blobs * (4 + 3 * 8)


def _check_mask(mask: torch.Tensor) -> None:
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2D (H, W), got shape "
                         f"{tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    if mask.shape[0] * mask.shape[1] >= 2 ** 31:
        raise ValueError("H*W must stay below 2^31 (int32 flat labels)")


def _check_cuda_mask(mask: torch.Tensor) -> None:
    _check_mask(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"the kernel takes a CUDA tensor, got "
                         f"{mask.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")


class Launch(NamedTuple):
    """What one launch of the kernel leaves on the device: the labels, the
    number of components K (one int32), the root list, the list slot of
    each component (its root is ``roots[blob_slot[k]]``, k < K) and the
    (3, capacity) int64 sums at the slots (counts, row sums, column
    sums)."""
    labels: torch.Tensor
    n_blobs: torch.Tensor
    roots: torch.Tensor
    blob_slot: torch.Tensor
    sums: torch.Tensor


def launch(mask: torch.Tensor, band: int = 0, moments: bool = True
           ) -> Launch:
    """Launches the kernel on a contiguous CUDA mask without waiting for
    it. With ``moments``, the K components are listed in no particular
    order; ``band`` > 0 sums
    band-local rows ``row % band``."""
    global LAUNCHES
    _check_cuda_mask(mask)
    if band < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    lib = _library()
    H, W = mask.shape
    dev = mask.device
    cap = root_capacity(H, W)
    labels = torch.empty((H, W), dtype=torch.int32, device=dev)
    ints = torch.empty(0, dtype=torch.int32, device=dev)
    roots = slot_of = blob_slot = ints
    sums = torch.empty((3, 0), dtype=torch.int64, device=dev)
    if H * W == 0:
        return Launch(labels, torch.zeros(1, dtype=torch.int32, device=dev),
                      roots, blob_slot, sums)
    n_blobs = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed there
    tile_roots = torch.empty(tile_count(H, W), dtype=torch.int32, device=dev)
    roots = torch.empty(cap, dtype=torch.int32, device=dev)
    if moments:
        slot_of = torch.empty(H * W, dtype=torch.int32, device=dev)
        sums = torch.empty((3, cap), dtype=torch.int64, device=dev)
        blob_slot = torch.empty(cap, dtype=torch.int32, device=dev)

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cc_label_launch(
            mask.data_ptr(), labels.data_ptr(), H, W, band, int(moments),
            n_blobs.data_ptr(), tile_roots.data_ptr(), roots.data_ptr(),
            ptr(slot_of), ptr(sums), ptr(blob_slot), cap, stream)
    if err != 0:
        raise RuntimeError("cc_label kernel launch failed: "
                           + lib.cc_error_string(err).decode())
    LAUNCHES += 1
    return Launch(labels, n_blobs, roots, blob_slot, sums)


def label_components_cuda(mask: torch.Tensor) -> torch.Tensor:
    """Runs the CUDA kernel on a CUDA mask; returns int32 labels."""
    return launch(mask, moments=False).labels


def blob_sums_cuda(mask: torch.Tensor, band: int = 0
                   ) -> Tuple[torch.Tensor, ...]:
    """(roots, counts, row_sums, col_sums), int64, one entry a component in
    ascending root order, from one launch of the kernel with the sums fused
    in; ``band`` as in :func:`launch`. Reads the number of components back
    to the host (one synchronisation)."""
    out = launch(mask, band, moments=True)
    slots = out.blob_slot[:int(out.n_blobs)].long()
    roots, order = torch.sort(out.roots[slots])   # int32 keys: 4 passes
    sums = out.sums[:, slots[order]]
    return roots.long(), sums[0], sums[1], sums[2]


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
