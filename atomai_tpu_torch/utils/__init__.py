"""Host-side utilities: images, synthetic lattices, coordinate grids, data
staging, atoms from masks, nearest-neighbour distances and bond maps,
atom-position refinement, clustering and tracking, lattice graphs and
their rings, blob filtering and ellipses, weight and class utilities, the
GP inputs of a sparse image, plotting, POSCAR files, the Zenodo data
sets, and the original atomai's utils surface (``compat``)."""

from . import compat, datasets, graphx, viz
from .aseutils import ase_obj_adv, ase_obj_basic
from .compat import (Hook, array2list, array2list_, channels2indices,
                     combine_classes_, dummy_optimizer, get_array_memsize,
                     init_cls_dataloaders, init_dataloader,
                     init_dataloaders, init_fcnn_dataloaders,
                     init_imspec_dataloaders, init_reg_dataloaders,
                     init_vae_dataloaders, load_weights, nb_filters_classes,
                     preprocess_training_cls_data,
                     preprocess_training_cls_data_,
                     preprocess_training_image_data,
                     preprocess_training_image_data_,
                     preprocess_training_imspec_data,
                     preprocess_training_imspec_data_,
                     preprocess_training_reg_data,
                     preprocess_training_reg_data_, set_seed_and_precision,
                     torch_format, torch_format_image, torch_format_spectra,
                     train_test_split)
from .coords import (chain_tracks, cluster_coord, compare_coordinates,
                     find_com, find_coord_clusters, gaussian_2d,
                     get_intensities, get_intensities_,
                     get_lengthscale_constraints, get_nn_distances,
                     get_nn_distances_, grid2xy, imcoordgrid, map_bonds,
                     mean_nn_distance, peak_refinement, remove_edge_coord,
                     subimg_trajectories, transform_coordinates)
from .graphx import (Graph, Node, filter_subgraphs, find_cycle_clusters,
                     find_cycles, get_interatomic_r, plot_graph)
from .img import (FFTmask, FFTsub, crop_borders, cv_resize,
                  cv_resize_stack, cv_rotate, cv_thresh, extract_patches,
                  extract_patches_2d, extract_patches_and_spectra,
                  extract_random_subimages, extract_subimages, filter_cells,
                  get_blob_params, get_contours, get_coord_grid,
                  get_imgstack, img_pad, img_resize, load_image, threshImg)
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    create_multiclass_lattice_mask, make_lattice_stack)
from .nn import (average_weights, combine_classes, get_downsample_factor,
                 get_nb_classes, gpu_usage_map, mock_forward, num_params,
                 renumerate_classes, reset_bnorm, sample_weights,
                 set_train_rng, weights_init)
from .preproc import (as_channel_last_images, cast_image_arrays,
                      check_image_dims, check_signal_dims, create_batches,
                      data_split, format_image, format_spectra,
                      num_classes_from_labels, prepare_gp_input,
                      preprocess_denoiser_data, squeeze_mask_channels,
                      stack_batches, to_onehot)
from .viz import (animation_from_png, draw_boxes, plot_coord,
                  plot_lattice_bonds, plot_losses, plot_trajectories,
                  plot_transitions, visualize_unmixing_results)

__all__ = [
    # preproc
    "num_classes_from_labels", "check_image_dims", "check_signal_dims",
    "format_image", "format_spectra", "data_split", "to_onehot",
    "create_batches", "stack_batches", "prepare_gp_input",
    "as_channel_last_images", "squeeze_mask_channels", "cast_image_arrays",
    "preprocess_denoiser_data",
    # coords
    "find_com", "grid2xy", "imcoordgrid", "transform_coordinates",
    "get_nn_distances", "get_nn_distances_", "gaussian_2d",
    "peak_refinement", "get_intensities", "get_intensities_",
    "compare_coordinates", "cluster_coord", "find_coord_clusters",
    "subimg_trajectories", "chain_tracks", "map_bonds",
    "remove_edge_coord", "get_lengthscale_constraints", "mean_nn_distance",
    # img
    "img_resize", "cv_resize", "cv_resize_stack", "cv_rotate", "img_pad",
    "get_imgstack", "extract_subimages", "extract_random_subimages",
    "extract_patches", "extract_patches_2d", "extract_patches_and_spectra",
    "FFTmask", "FFTsub", "threshImg", "crop_borders", "get_coord_grid",
    "cv_thresh", "filter_cells", "get_blob_params", "load_image",
    "get_contours",
    # nn
    "average_weights", "sample_weights", "set_train_rng", "weights_init",
    "reset_bnorm", "num_params", "combine_classes", "renumerate_classes",
    "mock_forward", "get_nb_classes", "get_downsample_factor",
    "gpu_usage_map",
    # imgen
    "MakeAtom", "create_lattice_mask", "create_multiclass_lattice_mask",
    "create_atom_mask_pair", "make_lattice_stack",
    # viz and graphx
    "viz", "plot_losses", "plot_coord", "draw_boxes", "animation_from_png",
    "plot_lattice_bonds", "plot_trajectories", "plot_transitions",
    "visualize_unmixing_results", "graphx", "Graph", "Node",
    "get_interatomic_r", "find_cycles", "find_cycle_clusters",
    "filter_subgraphs", "plot_graph",
    # aseutils, datasets and compat
    "ase_obj_basic", "ase_obj_adv", "datasets", "compat",
    "torch_format_image", "torch_format_spectra", "torch_format",
    "train_test_split", "array2list", "array2list_", "get_array_memsize",
    "init_dataloader", "init_dataloaders", "init_fcnn_dataloaders",
    "init_imspec_dataloaders", "init_reg_dataloaders",
    "init_cls_dataloaders", "init_vae_dataloaders",
    "preprocess_training_image_data", "preprocess_training_imspec_data",
    "preprocess_training_reg_data", "preprocess_training_cls_data",
    "preprocess_training_image_data_", "preprocess_training_imspec_data_",
    "preprocess_training_reg_data_", "preprocess_training_cls_data_",
    "load_weights", "Hook", "set_seed_and_precision", "dummy_optimizer",
    "nb_filters_classes", "channels2indices", "combine_classes_",
]
