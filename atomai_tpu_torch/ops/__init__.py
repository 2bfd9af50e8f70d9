"""Device ops: connected-component labels and blob centres (the
segmentation path), and the rVAE's fused spatial-decoder MLP. Each kernel
sits beside its plain torch version."""

from . import cc_kernel, spatial_mlp
from .cc_kernel import (label_components, label_components_cuda,
                        label_components_reference)
from .cc_label import blob_centers, blob_centers_tiled, tile_frames
from .spatial_mlp import (mlp_shapes_supported,
                          spatial_mlp_backward_reference,
                          spatial_mlp_reference)

__all__ = ["cc_kernel", "spatial_mlp", "label_components",
           "label_components_cuda", "label_components_reference",
           "blob_centers", "blob_centers_tiled", "tile_frames",
           "mlp_shapes_supported", "spatial_mlp_reference",
           "spatial_mlp_backward_reference"]
