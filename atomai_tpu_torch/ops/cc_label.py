"""Per-blob centres of mass from connected-component labels, on the device.

Counterpart of `atomai_tpu/ops/cc_label.py:29-251`. :func:`blob_sums`
gives each component's root (its minimal flat index), pixel count and
row/column sums, int64 and exact (the JAX float32 sums are exact only
below 2^24), in ascending root order, which is scipy's label order:

- on a CUDA tensor, one launch of the labeller with the sums fused into it
  (:func:`cc_kernel.blob_sums_cuda`);
- on a CPU tensor, the plain version :func:`blob_sums_reference`: the
  plain labeller, then per-root ``bincount`` / ``index_add_`` into dense
  int64 accumulators (:func:`_blob_moments`), then the roots with pixels
  (:func:`_blob_extract`).

No static ``max_blobs`` bound or padding is needed.
:func:`blob_centers_tiled` runs a whole stack as one tall image: frames are
stacked with a one-row background separator that 4-connectivity cannot
cross. The JAX package's per-frame ``blob_centers_stack`` loop, a
workaround for XLA's vmapped gathers, is not ported.
"""

from typing import Tuple

import torch

from .cc_kernel import blob_sums_cuda, label_components_reference

# largest tiled image run as one labelling: labels are int32 flat indices,
# with headroom below 2^31 for the background value
_INT32_SAFE_PIXELS = 2 ** 31 - 2 ** 20

# device-memory cap on one tiled chunk. On the card (the kernel) peak use
# is about 26 B/px: the bool mask and its tiled copy (2), int32 labels (4),
# each root's list slot at its pixel (4), and a list slot for at most one
# tile-local root per two pixels (root and component slot, 4 each; sums,
# 24: 16 a pixel). The plain version takes about 72 B/px when every pixel
# is foreground (int64 indices, roots, rows and columns, counts and sums).
# 2^27 px is then 3.5 GB on the card, 9.7 GB for the plain version: an
# eighth of an 80 GB card at most, which leaves the rest to the model, its
# activations and the maps.
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
                  col_sum: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(roots, counts, row_sums, col_sums) of the roots with pixels, in
    ascending root order, from the dense per-root arrays."""
    roots = torch.nonzero(counts).squeeze(1)
    return roots, counts[roots], row_sum[roots], col_sum[roots]


def blob_sums_reference(mask: torch.Tensor, band: int = 0
                        ) -> Tuple[torch.Tensor, ...]:
    """The plain version of :func:`blob_sums`, on any device."""
    lab = label_components_reference(mask)
    return _blob_extract(*_blob_moments(lab, band))


def blob_sums(mask: torch.Tensor, band: int = 0
              ) -> Tuple[torch.Tensor, ...]:
    """(roots, counts, row_sums, col_sums) of the components of a (H, W)
    bool/uint8 mask, int64, in ascending root order: the plain version for
    a CPU tensor, the fused kernel for a CUDA tensor. ``band`` > 0 sums
    band-local rows ``row % band``."""
    if mask.device.type == "cpu":
        return blob_sums_reference(mask, band)
    if mask.device.type == "cuda":
        return blob_sums_cuda(mask.contiguous(), band)
    raise ValueError(f"blob_sums runs on 'cpu' or 'cuda' tensors, got "
                     f"device {mask.device}")


def blob_means(roots: torch.Tensor, counts: torch.Tensor,
               row_sum: torch.Tensor, col_sum: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(coords (K, 2) float32 [row, col], sizes (K,) int64, roots (K,)
    int64) from :func:`blob_sums`' output. The means are divided in
    float64 and rounded once to float32."""
    c = counts.double()
    coords = torch.stack([row_sum.double() / c, col_sum.double() / c], dim=1)
    return coords.float(), counts, roots


def blob_centers(mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centres of mass (K, 2) and pixel counts (K,) of the components of a
    (H, W) mask, as ``ndimage.center_of_mass`` gives them for binary
    weights, in scipy's label order."""
    coords, sizes, _ = blob_means(*blob_sums(mask))
    return coords, sizes


def tile_frames(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool masks -> (N*(H+1), W), each frame followed by one
    background row."""
    N, H, W = masks.shape
    tiled = torch.zeros((N, H + 1, W), dtype=torch.bool, device=masks.device)
    tiled[:, :H] = masks if masks.dtype == torch.bool else masks != 0
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
        coords, sizes, roots = blob_means(*blob_sums(
            tile_frames(masks[s:s + max_frames]), band=H + 1))
        # a root is its blob's minimal flat index: exact integer division
        # recovers the frame
        frames = torch.div(roots, W * (H + 1), rounding_mode="floor")
        parts.append((coords, frames + s, sizes))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))
