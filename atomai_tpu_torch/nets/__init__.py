"""Segmentation nets and their blocks."""

from .blocks import ConvBlock, UpsampleBlock, init_weights_, max_pool
from .fcnn import DOWNSAMPLE_FACTORS, Unet, init_fcnn_model

__all__ = ["ConvBlock", "UpsampleBlock", "init_weights_", "max_pool",
           "DOWNSAMPLE_FACTORS", "Unet", "init_fcnn_model"]
