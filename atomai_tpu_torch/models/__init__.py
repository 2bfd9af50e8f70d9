"""User-facing models, their loader and the JAX weight bridge."""

from .conversion import unet_from_jax, vae_from_jax
from .dgm import VAE, rVAE
from .loaders import load_model
from .segmentor import Segmentor

__all__ = ["Segmentor", "VAE", "rVAE", "load_model", "unet_from_jax",
           "vae_from_jax"]
