"""Host-side utilities: images, synthetic lattices, coordinate grids, data
staging, atom-position refinement, clustering and tracking, weight
averaging, the GP inputs of a sparse image, and the GIF of a VAE's
manifold recording."""

from .coords import (chain_tracks, cluster_coord, compare_coordinates,
                     get_intensities, get_intensities_,
                     get_lengthscale_constraints, grid2xy, imcoordgrid,
                     mean_nn_distance, peak_refinement, remove_edge_coord,
                     subimg_trajectories, transform_coordinates)
from .img import (crop_borders, extract_patches_2d, extract_subimages,
                  get_coord_grid, img_pad, img_resize, load_image)
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    make_lattice_stack)
from .nn import average_weights, sample_weights
from .preproc import (as_channel_last_images, cast_image_arrays,
                      check_image_dims, check_signal_dims, create_batches,
                      data_split, format_image, format_spectra,
                      num_classes_from_labels, prepare_gp_input,
                      squeeze_mask_channels, stack_batches, to_onehot)

__all__ = ["chain_tracks", "subimg_trajectories", "crop_borders",
           "extract_subimages", "get_coord_grid", "cluster_coord", "grid2xy", "imcoordgrid", "mean_nn_distance",
           "peak_refinement", "average_weights", "sample_weights",
           "transform_coordinates", "extract_patches_2d", "img_pad",
           "img_resize", "MakeAtom", "create_atom_mask_pair",
           "create_lattice_mask", "make_lattice_stack",
           "as_channel_last_images", "cast_image_arrays", "check_image_dims",
           "check_signal_dims", "create_batches", "data_split",
           "format_image", "format_spectra",
           "num_classes_from_labels", "squeeze_mask_channels",
           "stack_batches", "to_onehot", "prepare_gp_input",
           "get_lengthscale_constraints", "get_intensities",
           "get_intensities_", "compare_coordinates", "remove_edge_coord",
           "load_image"]
