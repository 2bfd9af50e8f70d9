"""Data augmentation and geometric warps, on the device."""

from .imaug import (DataTransform, datatransform, seg_augmentor,
                    squeeze_channels, unsqueeze_channels)
from .warp import (bilinear_sample, interp_matrix, rotate_image,
                   separable_sample, separable_sample_nhwc)

__all__ = ["DataTransform", "datatransform", "seg_augmentor",
           "squeeze_channels", "unsqueeze_channels", "bilinear_sample",
           "interp_matrix", "rotate_image", "separable_sample",
           "separable_sample_nhwc"]
