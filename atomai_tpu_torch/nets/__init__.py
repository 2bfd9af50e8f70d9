"""Segmentation nets, the VAE family's encoders and decoders, and their
blocks."""

from .blocks import ConvBlock, UpsampleBlock, init_weights_, max_pool
from .ed import (convEncoderNet, coord_latent, fcDecoderNet, fcEncoderNet,
                 init_VAE_nets, rDecoderNet)
from .fcnn import DOWNSAMPLE_FACTORS, Unet, init_fcnn_model

__all__ = ["ConvBlock", "UpsampleBlock", "init_weights_", "max_pool",
           "convEncoderNet", "coord_latent", "fcDecoderNet", "fcEncoderNet",
           "init_VAE_nets", "rDecoderNet", "DOWNSAMPLE_FACTORS", "Unet",
           "init_fcnn_model"]
