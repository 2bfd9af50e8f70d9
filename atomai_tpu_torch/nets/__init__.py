"""Segmentation nets, the im2spec nets, the regression and classification
nets and their backbones, the VAE family's encoders and decoders, their
blocks, the GP feature extractors and kernels, and rematerialisation."""

from .backbones import (BACKBONE_FEATURES, Bottleneck, InvertedResidual,
                        MobileNetV2Features, ResNet50Features, VGG16Features)
from .blocks import (ConvBackbone, ConvBlock, DilatedBlock, Dropout,
                     ResBlock, ResModule, UpsampleBlock, init_weights_,
                     max_pool)
from .ed import (SignalDecoder, SignalED, SignalEncoder, convDecoderNet,
                 convEncoderNet, coord_latent, fcDecoderNet, fcEncoderNet,
                 init_imspec_model, init_VAE_nets, jconvEncoderNet,
                 jfcEncoderNet, rDecoderNet)
from .fcnn import (DOWNSAMPLE_FACTORS, ResHedNet, SegResNet, Unet, dilnet,
                   init_fcnn_model)
from .gp import (KERNELS, CustomGPModel, GPRegressionModel,
                 StackedFeatureExtractor, fcFeatureExtractor, init_gp_params,
                 matern52_kernel, rbf_kernel, scale_to_bounds)
from .reg_cls import (ClassifierNet, MultiTaskClassifierNet, RegressorNet,
                      init_cls_model, init_mtask_cls_model, init_reg_model)
from .remat import Rematerializable, checkpointed, set_remat

# the original atomai name of the backbone wrapper
CustomBackbone = ConvBackbone

__all__ = ["set_remat", "checkpointed", "Rematerializable",
           "CustomBackbone", "ConvBlock", "DilatedBlock", "Dropout", "UpsampleBlock",
           "ResBlock", "ResModule", "ConvBackbone", "init_weights_",
           "max_pool", "BACKBONE_FEATURES", "Bottleneck", "InvertedResidual",
           "MobileNetV2Features", "ResNet50Features", "VGG16Features",
           "dilnet", "ResHedNet", "SegResNet", "RegressorNet",
           "ClassifierNet", "MultiTaskClassifierNet", "init_reg_model",
           "init_cls_model", "init_mtask_cls_model",
           "SignalDecoder", "SignalED", "SignalEncoder", "init_imspec_model",
           "convEncoderNet", "coord_latent", "fcDecoderNet", "fcEncoderNet",
           "jfcEncoderNet", "jconvEncoderNet", "convDecoderNet",
           "init_VAE_nets", "rDecoderNet", "DOWNSAMPLE_FACTORS", "Unet",
           "init_fcnn_model", "fcFeatureExtractor", "StackedFeatureExtractor",
           "rbf_kernel", "matern52_kernel", "scale_to_bounds",
           "init_gp_params", "KERNELS", "GPRegressionModel", "CustomGPModel"]
