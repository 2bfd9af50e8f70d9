"""Host-side utilities: images, synthetic lattices, coordinate grids."""

from .coords import grid2xy, imcoordgrid, transform_coordinates
from .img import extract_patches_2d, img_pad, img_resize
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    make_lattice_stack)
from .preproc import as_channel_last_images, format_image, to_onehot

__all__ = ["grid2xy", "imcoordgrid", "transform_coordinates",
           "extract_patches_2d", "img_pad", "img_resize", "MakeAtom",
           "create_atom_mask_pair", "create_lattice_mask",
           "make_lattice_stack", "as_channel_last_images", "format_image",
           "to_onehot"]
