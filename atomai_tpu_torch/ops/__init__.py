"""Device ops: connected-component labels and blob centres (the
segmentation path), batched 2D-Gaussian peak refinement, and the rVAE's
fused spatial-decoder MLP. Each kernel sits beside its plain torch
version."""

from . import cc_kernel, spatial_mlp
from .cc_kernel import (blob_sums_cuda, label_components,
                        label_components_cuda, label_components_reference)
from .cc_label import (blob_centers, blob_centers_tiled, blob_means,
                       blob_sums, blob_sums_reference, tile_frames)
from .peakfit import refine_peaks
from .spatial_mlp import (mlp_shapes_supported,
                          spatial_mlp_backward_reference,
                          spatial_mlp_reference)

__all__ = ["cc_kernel", "spatial_mlp", "label_components",
           "label_components_cuda", "label_components_reference",
           "blob_sums", "blob_sums_cuda", "blob_sums_reference",
           "blob_means", "blob_centers", "blob_centers_tiled", "tile_frames",
           "refine_peaks", "mlp_shapes_supported", "spatial_mlp_reference",
           "spatial_mlp_backward_reference"]
