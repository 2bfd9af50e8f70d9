"""User-facing models and the JAX weight bridge."""

from .conversion import unet_from_jax
from .segmentor import Segmentor

__all__ = ["Segmentor", "unet_from_jax"]
