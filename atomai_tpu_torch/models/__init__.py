"""User-facing models, their loaders, the JAX weight bridge and the
loaders of the original atomai's checkpoints."""

from .classifier import Classifier
from .conversion import (denoiser_from_jax, dkl_fe_from_jax, dkl_from_jax,
                         ensemble_from_jax, fcnn_from_jax,
                         load_pretrained_model, load_torch_checkpoint,
                         load_torch_ensemble, reg_cls_from_jax,
                         signal_ed_from_jax, unet_from_jax, vae_from_jax)
from .denoiser import (DenoisingAutoencoder, denoise_images,
                       init_denoising_autoencoder)
from .dgm import VAE, BaseVAE, jrVAE, jVAE, make_grid, rVAE
from .dklgp import Reconstructor, dklGPR
from .imspec import ImSpec
from .loaders import (load_cls_model, load_denoising_autoencoder,
                      load_ensemble, load_imspec_model, load_model,
                      load_reg_model, load_seg_model, load_vae_model)
from .regressor import Regressor
from .segmentor import Segmentor

__all__ = ["Segmentor", "ImSpec", "Regressor", "Classifier",
           "DenoisingAutoencoder", "denoise_images",
           "init_denoising_autoencoder", "BaseVAE", "VAE", "rVAE", "jVAE", "jrVAE",
           "make_grid", "load_model",
           "load_ensemble", "load_seg_model", "load_imspec_model",
           "load_reg_model", "load_cls_model", "load_vae_model",
           "load_denoising_autoencoder", "fcnn_from_jax", "unet_from_jax",
           "vae_from_jax", "signal_ed_from_jax", "ensemble_from_jax",
           "reg_cls_from_jax", "denoiser_from_jax", "dklGPR",
           "Reconstructor", "dkl_from_jax", "dkl_fe_from_jax",
           "load_torch_checkpoint", "load_torch_ensemble",
           "load_pretrained_model"]
