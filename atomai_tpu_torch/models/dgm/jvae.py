"""jVAE: the joint continuous + discrete VAE.

Counterpart of `atomai_tpu/models/dgm/jvae.py:19-72` (after
arXiv:1804.00104): besides the Gaussian latents, one Gumbel-softmax
latent per entry of ``discrete_dim``, sampled at a temperature (0.67 by
default), and the ELBO's continuous and discrete KL terms held to their
capacity schedules (``cont_capacity``, ``disc_capacity``).
"""

from copy import deepcopy as dc
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ...losses_metrics.vi_losses import joint_vae_loss
from .vae import BaseVAE


class JointSampling:
    """The draws of a joint model's latents: z = [continuous sample,
    Gumbel-softmax sample of each discrete head]. The generator draws the
    Gaussian noise first, then each head's uniforms in order; ``eps`` and
    ``u`` (a list, one array per head) replace the draws."""

    def _sample_joint(self, latent: Sequence[torch.Tensor],
                      generator: Optional[torch.Generator],
                      eps: Optional[torch.Tensor],
                      u: Optional[Sequence[torch.Tensor]]
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        z_mean, z_logsd = latent[:2]
        alphas = list(latent[2:])
        z_cont = self.reparameterize(z_mean, torch.exp(z_logsd), generator,
                                     eps)
        tau = self.kdict_.get("temperature", .67)
        z_disc = [self.reparameterize_discrete(
            a, tau, generator, None if u is None else u[k])
            for k, a in enumerate(alphas)]
        return z_cont, z_disc


class jVAE(JointSampling, BaseVAE):
    """Joint continuous and discrete VAE.

    Example:
        >>> jvae = jVAE((28, 28), latent_dim=2, discrete_dim=[10],
        ...             device="cuda")
        >>> jvae.fit(imstack_train, training_cycles=100)
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 discrete_dim: List[int] = [2], nb_classes: int = 0,
                 seed: int = 0, **kwargs: Any) -> None:
        super().__init__(in_dim, latent_dim, nb_classes, 0,
                         list(discrete_dim), seed=seed, **kwargs)
        self.kdict_ = dc(kwargs)

    def elbo_fn(self, x, x_reconstr, *args, **kwargs):
        return joint_vae_loss(self.loss, self.in_dim, x, x_reconstr, *args,
                              **kwargs)

    def forward_compute_elbo(self, x, y, num_iter, generator=None,
                             eps=None, u=None):
        """Encode, sample the continuous and discrete latents, decode
        (with the one-hot labels of a class-conditional model), ELBO."""
        latent = self.encoder_net(x)
        z_cont, z_disc = self._sample_joint(latent, generator, eps, u)
        z = torch.cat([z_cont] + z_disc, 1)
        if y is not None:
            z = torch.cat([z, self._one_hot(y)], -1)
        x_reconstr = self.decoder_net(z)
        kw = {k: v for k, v in self.kdict_.items()
              if k in ("cont_capacity", "disc_capacity")}
        return self.elbo_fn(x, x_reconstr, *latent[:2], latent[2:],
                            num_iter=num_iter, **kw)

    def fit(self, X_train, y_train=None, X_test=None, y_test=None,
            loss: str = "mse", **kwargs) -> None:
        """Trains the joint VAE; ``cont_capacity``, ``disc_capacity`` and
        ``temperature`` may be given here or to the constructor."""
        self._prepare_fit(X_train, y_train, X_test, y_test, kwargs,
                          ("cont_capacity", "disc_capacity", "temperature"))
        self._fit_loop(X_train, y_train, X_test, y_test, loss, **kwargs)
