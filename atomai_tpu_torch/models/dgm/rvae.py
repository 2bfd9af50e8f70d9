"""rVAE: the rotationally and translationally invariant VAE.

Counterpart of `atomai_tpu/models/dgm/rvae.py:23-86` (Bepler et al.'s
spatial decoder, arXiv:1909.11663). The encoder's first latent is the
rotation angle phi and, with ``translation``, the next two are the xy
shift; the pixel grid is rotated and shifted per sample before the
spatial decoder, which then sees only the remaining latents (plus the
one-hot class of a class-conditional model).
"""

from copy import deepcopy as dc
from typing import Any, Tuple

import torch

from ...losses_metrics.vi_losses import rvae_loss
from .vae import BaseVAE


class rVAE(BaseVAE):
    """Rotationally invariant VAE with a spatial decoder.

    Example:
        >>> rvae = rVAE((28, 28), device="cuda")
        >>> rvae.fit(imstack_train, training_cycles=100, batch_size=100,
        ...          rotation_prior=np.pi / 2)
        >>> rvae.manifold2d()
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 nb_classes: int = 0, translation: bool = True,
                 seed: int = 0, **kwargs: Any) -> None:
        coord = 3 if translation else 1
        super().__init__(in_dim, latent_dim, nb_classes, coord, seed=seed,
                         **kwargs)
        self.translation = translation
        self.dx_prior = None
        self.kdict_ = dc(kwargs)

    def elbo_fn(self, x, x_reconstr, *args, **kwargs):
        return rvae_loss(self.loss, self.in_dim, x, x_reconstr, *args,
                         **kwargs)

    def forward_compute_elbo(self, x, y, num_iter, generator=None,
                             eps=None):
        """Encode, sample z = [phi, dx (2), z], transform the pixel grid,
        decode, ELBO with the rotation prior."""
        z_mean, z_logsd = self.encoder_net(x)
        z = self.reparameterize(z_mean, torch.exp(z_logsd), generator, eps)
        x_coord, z = self._transformed_grid(z)
        if y is not None:
            z = torch.cat([z, self._one_hot(y)], -1)
        x_reconstr = self.decoder_net(x_coord, z)
        kw = {k: v for k, v in self.kdict_.items()
              if k in ("phi_prior", "capacity")}
        return self.elbo_fn(x, x_reconstr, z_mean, z_logsd,
                            num_iter=num_iter, **kw)

    def fit(self, X_train, y_train=None, X_test=None, y_test=None,
            loss: str = "mse", **kwargs) -> None:
        """Trains the rVAE; ``rotation_prior`` and ``translation_prior``
        (both 0.1 by default) set the priors' widths."""
        self._prepare_fit(X_train, y_train, X_test, y_test, kwargs,
                          ("capacity",))
        self._fit_loop(X_train, y_train, X_test, y_test, loss, **kwargs)
