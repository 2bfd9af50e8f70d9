"""Host-side utilities of the segmentation path."""

from .img import img_pad, img_resize
from .imgen import (MakeAtom, create_atom_mask_pair, create_lattice_mask,
                    make_lattice_stack)
from .preproc import as_channel_last_images, format_image

__all__ = ["img_pad", "img_resize", "MakeAtom", "create_atom_mask_pair",
           "create_lattice_mask", "make_lattice_stack",
           "as_channel_last_images", "format_image"]
