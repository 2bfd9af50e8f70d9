"""Host-side utilities: images, synthetic lattices, coordinate grids, data
staging and atom-position refinement."""

from .coords import (grid2xy, imcoordgrid, mean_nn_distance,
                     peak_refinement, transform_coordinates)
from .img import extract_patches_2d, img_pad, img_resize
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    make_lattice_stack)
from .preproc import (as_channel_last_images, cast_image_arrays,
                      check_image_dims, create_batches, data_split,
                      format_image, num_classes_from_labels,
                      squeeze_mask_channels, stack_batches, to_onehot)

__all__ = ["grid2xy", "imcoordgrid", "mean_nn_distance", "peak_refinement",
           "transform_coordinates", "extract_patches_2d", "img_pad",
           "img_resize", "MakeAtom", "create_atom_mask_pair",
           "create_lattice_mask", "make_lattice_stack",
           "as_channel_last_images", "cast_image_arrays", "check_image_dims",
           "create_batches", "data_split", "format_image",
           "num_classes_from_labels", "squeeze_mask_channels",
           "stack_batches", "to_onehot"]
