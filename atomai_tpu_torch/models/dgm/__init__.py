"""Deep generative models: the VAE family."""

from .jrvae import jrVAE
from .jvae import jVAE
from .rvae import rVAE
from .vae import VAE, BaseVAE, make_grid

__all__ = ["BaseVAE", "VAE", "rVAE", "jVAE", "jrVAE", "make_grid"]
