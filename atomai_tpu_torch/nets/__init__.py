"""Segmentation nets, the im2spec nets, the VAE family's encoders and
decoders, their blocks, and the GP feature extractors and kernels."""

from .blocks import (ConvBlock, DilatedBlock, Dropout, UpsampleBlock,
                     init_weights_, max_pool)
from .ed import (SignalDecoder, SignalED, SignalEncoder, convEncoderNet,
                 coord_latent, fcDecoderNet, fcEncoderNet, init_imspec_model,
                 init_VAE_nets, rDecoderNet)
from .fcnn import DOWNSAMPLE_FACTORS, Unet, init_fcnn_model
from .gp import (KERNELS, CustomGPModel, GPRegressionModel,
                 StackedFeatureExtractor, fcFeatureExtractor, init_gp_params,
                 matern52_kernel, rbf_kernel, scale_to_bounds)

__all__ = ["ConvBlock", "DilatedBlock", "Dropout", "UpsampleBlock",
           "init_weights_", "max_pool",
           "SignalDecoder", "SignalED", "SignalEncoder", "init_imspec_model",
           "convEncoderNet", "coord_latent", "fcDecoderNet", "fcEncoderNet",
           "init_VAE_nets", "rDecoderNet", "DOWNSAMPLE_FACTORS", "Unet",
           "init_fcnn_model", "fcFeatureExtractor", "StackedFeatureExtractor",
           "rbf_kernel", "matern52_kernel", "scale_to_bounds",
           "init_gp_params", "KERNELS", "GPRegressionModel", "CustomGPModel"]
