"""Per-blob centres of mass from connected-component labels, on the device.

Counterpart of `atomai_tpu/ops/cc_label.py:29-251`:

1. label the mask (:func:`cc_kernel.label_components`: the CUDA kernel on
   the card, the plain loop on the CPU);
2. per-root pixel counts and first moments with ``bincount`` /
   ``index_add_`` into int64 accumulators, which are exact (the JAX
   float32 sums are exact only below 2^24);
3. extract the blobs with ``torch.nonzero``: blobs come out in raster order
   of their roots (minimal flat indices), which is scipy's label order, and
   no static ``max_blobs`` bound or padding is needed.

:func:`blob_centers_tiled` runs a whole stack as one tall image: frames are
stacked with a one-row background separator that 4-connectivity cannot
cross. The JAX package's per-frame ``blob_centers_stack`` loop, a
workaround for XLA's vmapped gathers, is not ported.
"""

from typing import Tuple

import torch

from .cc_kernel import label_components

# largest tiled image run as one labelling: labels are int32 flat indices,
# with headroom below 2^31 for the background value
_INT32_SAFE_PIXELS = 2 ** 31 - 2 ** 20

# device-memory cap on one tiled chunk. Peak use is about 72 B/px when
# every pixel is foreground: the bool mask and its tiled copy (2), int32
# labels (4), the foreground test (1), int64 pixel indices, roots, band
# rows and columns (4 x 8), int64 counts and row/col sums (3 x 8), and
# int64 temporaries of the index arithmetic (~9). 2^27 px is then ~9.7 GB,
# an eighth of an 80 GB card, which leaves the rest to the model, its
# activations and the probability maps.
_TILED_PIXEL_BUDGET = 2 ** 27


def _blob_moments(lab: torch.Tensor, band: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-root pixel counts and row/col sums, int64, indexed by root.

    ``band`` > 0 (the tiled path) sums band-local rows ``row % band``, so a
    blob's mean row is its row inside its frame."""
    H, W = lab.shape
    n = H * W
    flat = lab.reshape(-1)
    pix = torch.nonzero(flat < n).squeeze(1)
    roots = flat[pix].long()
    rows = torch.div(pix, W, rounding_mode="floor")
    if band:
        rows = rows % band
    cols = pix % W
    counts = torch.bincount(roots, minlength=n)
    row_sum = torch.zeros(n, dtype=torch.int64, device=lab.device)
    col_sum = torch.zeros(n, dtype=torch.int64, device=lab.device)
    row_sum.index_add_(0, roots, rows)
    col_sum.index_add_(0, roots, cols)
    return counts, row_sum, col_sum


def _blob_extract(counts: torch.Tensor, row_sum: torch.Tensor,
                  col_sum: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(coords (K, 2) float32 [row, col], sizes (K,) int64, roots (K,)
    int64) of the K blobs, in ascending root order. The means are divided
    in float64 and rounded once to float32."""
    roots = torch.nonzero(counts).squeeze(1)
    sizes = counts[roots]
    c = sizes.double()
    coords = torch.stack([row_sum[roots].double() / c,
                          col_sum[roots].double() / c], dim=1)
    return coords.float(), sizes, roots


def blob_centers(mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centres of mass (K, 2) and pixel counts (K,) of the components of a
    (H, W) mask, as ``ndimage.center_of_mass`` gives them for binary
    weights, in scipy's label order."""
    lab = label_components(mask)
    coords, sizes, _ = _blob_extract(*_blob_moments(lab))
    return coords, sizes


def tile_frames(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool masks -> (N*(H+1), W), each frame followed by one
    background row."""
    N, H, W = masks.shape
    tiled = torch.zeros((N, H + 1, W), dtype=torch.bool, device=masks.device)
    tiled[:, :H] = masks != 0
    return tiled.reshape(N * (H + 1), W)


def blob_centers_tiled(masks: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Blob centres of a whole (N, H, W) stack, labelled as one tall image
    per chunk.

    Returns, on the masks' device: frame-local coords (K, 2) float32,
    frames (K,) int64, sizes (K,) int64; blob order is frame-major, then
    raster order within a frame, the same as running :func:`blob_centers`
    frame by frame.
    """
    N, H, W = masks.shape
    max_frames = max(1, min(_INT32_SAFE_PIXELS, _TILED_PIXEL_BUDGET)
                     // ((H + 1) * W))
    parts = []
    for s in range(0, N, max_frames):
        lab = label_components(tile_frames(masks[s:s + max_frames]))
        coords, sizes, roots = _blob_extract(*_blob_moments(lab, band=H + 1))
        # a root is its blob's minimal flat index: exact integer division
        # recovers the frame
        frames = torch.div(roots, W * (H + 1), rounding_mode="floor")
        parts.append((coords, frames + s, sizes))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))
