"""jrVAE: the joint continuous + discrete, rotationally invariant VAE.

Counterpart of `atomai_tpu/models/dgm/jrvae.py:20-92`: the rVAE's spatial
decoder (the first continuous latent rotates the pixel grid, the next two
shift it by ``translation_prior`` times their value) fed with the other
continuous latents and the Gumbel-softmax samples of the discrete ones,
and the joint ELBO with the rotation prior and both capacity schedules.
With ``skip=True`` (the generative skip decoder) the decoder adds its
first layer's output, with no tanh, after every hidden layer; it takes
the fused route too (the spatial-MLP kernels' residual variant on a
card). On a card its training step replays from the trainer's CUDA graph,
its draws and step counts made up front (``trainers/vitrainer.py``).
"""

from copy import deepcopy as dc
from typing import Any, List, Tuple

import torch

from ...losses_metrics.vi_losses import joint_rvae_loss
from ...utils.coords import transform_coordinates
from .jvae import JointSampling
from .vae import BaseVAE


class jrVAE(JointSampling, BaseVAE):
    """Joint rotationally invariant VAE.

    Example:
        >>> jrvae = jrVAE((28, 28), latent_dim=2, discrete_dim=[10],
        ...               device="cuda")
        >>> jrvae.fit(imstack_train, training_cycles=100,
        ...           rotation_prior=np.pi / 2)
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 discrete_dim: List[int] = [2], nb_classes: int = 0,
                 translation: bool = True, seed: int = 0,
                 **kwargs: Any) -> None:
        coord = 3 if translation else 1
        super().__init__(in_dim, latent_dim, nb_classes, coord,
                         list(discrete_dim), seed=seed, **kwargs)
        self.translation = translation
        self.dx_prior = None
        self.kdict_ = dc(kwargs)

    def elbo_fn(self, x, x_reconstr, *args, **kwargs):
        return joint_rvae_loss(self.loss, self.in_dim, x, x_reconstr, *args,
                               **kwargs)

    def forward_compute_elbo(self, x, y, num_iter, generator=None,
                             eps=None, u=None):
        """Encode, sample, rotate and shift the pixel grid by the first
        continuous latents, decode the rest with the discrete samples,
        ELBO with the rotation prior."""
        latent = self.encoder_net(x)
        z_cont, z_disc = self._sample_joint(latent, generator, eps, u)
        x_coord, z_cont = self._transformed_grid(z_cont)
        z = torch.cat([z_cont] + z_disc, 1)
        if y is not None:
            z = torch.cat([z, self._one_hot(y)], -1)
        x_reconstr = self.decoder_net(x_coord, z)
        kw = {k: v for k, v in self.kdict_.items()
              if k in ("phi_prior", "cont_capacity", "disc_capacity")}
        return self.elbo_fn(x, x_reconstr, *latent[:2], latent[2:],
                            num_iter=num_iter, **kw)

    def fit(self, X_train, y_train=None, X_test=None, y_test=None,
            loss: str = "mse", **kwargs) -> None:
        """Trains the joint rVAE; ``rotation_prior`` and
        ``translation_prior`` (0.1 by default) set the priors' widths;
        ``cont_capacity``, ``disc_capacity`` and ``temperature`` may be
        given here or to the constructor."""
        self._prepare_fit(X_train, y_train, X_test, y_test, kwargs,
                          ("cont_capacity", "disc_capacity", "temperature"))
        self._fit_loop(X_train, y_train, X_test, y_test, loss, **kwargs)
