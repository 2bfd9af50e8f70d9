"""User-facing models and the JAX weight bridge."""

from .conversion import unet_from_jax, vae_from_jax
from .dgm import VAE, rVAE
from .segmentor import Segmentor

__all__ = ["Segmentor", "VAE", "rVAE", "unet_from_jax", "vae_from_jax"]
