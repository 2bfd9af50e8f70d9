"""Device ops of the segmentation path: connected-component labels (CUDA
kernel + plain version) and per-blob centres of mass."""

from . import cc_kernel
from .cc_kernel import (label_components, label_components_cuda,
                        label_components_reference)
from .cc_label import blob_centers, blob_centers_tiled, tile_frames

__all__ = ["cc_kernel", "label_components", "label_components_cuda",
           "label_components_reference", "blob_centers",
           "blob_centers_tiled", "tile_frames"]
