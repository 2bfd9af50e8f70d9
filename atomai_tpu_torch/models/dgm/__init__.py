"""Deep generative models: the VAE family."""

from .rvae import rVAE
from .vae import VAE, BaseVAE

__all__ = ["BaseVAE", "VAE", "rVAE"]
