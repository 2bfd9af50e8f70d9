"""User-facing models, their loaders and the JAX weight bridge."""

from .conversion import (dkl_from_jax, ensemble_from_jax,
                         signal_ed_from_jax, unet_from_jax, vae_from_jax)
from .dgm import VAE, rVAE
from .dklgp import Reconstructor, dklGPR
from .imspec import ImSpec
from .loaders import load_ensemble, load_model
from .segmentor import Segmentor

__all__ = ["Segmentor", "ImSpec", "VAE", "rVAE", "load_model",
           "load_ensemble", "unet_from_jax", "vae_from_jax",
           "signal_ed_from_jax", "ensemble_from_jax", "dklGPR",
           "Reconstructor", "dkl_from_jax"]
