"""Host-side utilities: images, synthetic lattices, coordinate grids, data
staging, atom-position refinement and clustering, weight averaging, and
the GP inputs of a sparse image."""

from .coords import (cluster_coord, get_lengthscale_constraints, grid2xy,
                     imcoordgrid, mean_nn_distance, peak_refinement,
                     transform_coordinates)
from .img import extract_patches_2d, img_pad, img_resize
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    make_lattice_stack)
from .nn import average_weights, sample_weights
from .preproc import (as_channel_last_images, cast_image_arrays,
                      check_image_dims, check_signal_dims, create_batches,
                      data_split, format_image, format_spectra,
                      num_classes_from_labels, prepare_gp_input,
                      squeeze_mask_channels, stack_batches, to_onehot)

__all__ = ["cluster_coord", "grid2xy", "imcoordgrid", "mean_nn_distance",
           "peak_refinement", "average_weights", "sample_weights",
           "transform_coordinates", "extract_patches_2d", "img_pad",
           "img_resize", "MakeAtom", "create_atom_mask_pair",
           "create_lattice_mask", "make_lattice_stack",
           "as_channel_last_images", "cast_image_arrays", "check_image_dims",
           "check_signal_dims", "create_batches", "data_split",
           "format_image", "format_spectra",
           "num_classes_from_labels", "squeeze_mask_channels",
           "stack_batches", "to_onehot", "prepare_gp_input",
           "get_lengthscale_constraints"]
