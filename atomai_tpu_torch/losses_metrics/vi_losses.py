"""Variational-inference losses (ELBOs) of the VAE family.

Counterpart of `atomai_tpu/losses_metrics/vi_losses.py:19-176`: the
sum-reduced reconstruction loss, the closed-form normal KL, the discrete
(Gumbel-Softmax against a uniform categorical) KL, the rotation-prior KL,
the four ELBOs and Burgess-style information-capacity annealing. Each ELBO
is returned as a value to maximise. ``num_iter`` is a Python number, or a
0-d integer tensor (a step count on the card, which a CUDA graph's replays
read): the capacities are then clamped on the device, to the same float32
values.
Every mean over the batch is ``core.mesh.batch_mean``: in a step split
over a data mesh it is the global batch's, so each rank's ELBO is the one
of the whole batch (the capacity terms are not linear in it).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mesh import batch_mean


def reconstruction_loss(loss_type: str, in_dim: Tuple[int, ...],
                        x: torch.Tensor, x_reconstr: torch.Tensor,
                        logits: bool = True) -> torch.Tensor:
    """Per-sample reconstruction loss, summed over features."""
    batch_dim = x.shape[0]
    xr = x_reconstr.reshape(batch_dim, -1)
    xt = x.reshape(batch_dim, -1)
    if loss_type == "mse":
        diff = xr - xt
        return 0.5 * torch.sum(diff * diff, 1)
    if loss_type == "ce":
        if logits:
            per_el = (torch.clamp(xr, min=0.0) - xr * xt +
                      torch.log1p(torch.exp(-torch.abs(xr))))
        else:
            eps = 1e-12
            per_el = -(xt * torch.log(xr + eps) +
                       (1 - xt) * torch.log(1 - xr + eps))
        return torch.sum(per_el, -1)
    raise NotImplementedError("Reconstruction loss must be 'mse' or 'ce'")


def kld_normal(q_param: Sequence[torch.Tensor],
               p_param: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """KL divergence between two diagonal normals, summed over the latent
    dims; against the unit normal when ``p_param`` is None."""
    mu_1, log_sd_1 = q_param
    sd_1 = torch.exp(log_sd_1)
    if p_param is None:
        kl = -log_sd_1 + 0.5 * sd_1 ** 2 + 0.5 * mu_1 ** 2 - 0.5
    else:
        mu_2, log_sd_2 = p_param
        sd_2 = torch.exp(log_sd_2)
        kl = (log_sd_2 - log_sd_1 +
              0.5 * (sd_1 ** 2 + (mu_1 - mu_2) ** 2) / sd_2 ** 2 - 0.5)
    return torch.sum(kl, -1)


def kld_discrete(alpha: torch.Tensor) -> torch.Tensor:
    """KL between Gumbel-Softmax parameters and a uniform categorical,
    averaged over the batch; shape (1,)."""
    eps = 1e-12
    h1 = torch.log(alpha + eps)
    h2 = float(np.log(1.0 / alpha.shape[-1] + eps))
    return batch_mean(torch.sum(alpha * (h1 - h2), 1), 0).reshape(1)


def kld_rot(phi_prior: float, phi_logsd: torch.Tensor) -> torch.Tensor:
    """KL of the rotation latent against its prior's width."""
    phi_sd = torch.exp(phi_logsd)
    return (-phi_logsd + float(np.log(phi_prior)) +
            phi_sd ** 2 / (2 * phi_prior ** 2) - 0.5)


def _likelihood(recon_loss, in_dim, x, x_reconstr) -> torch.Tensor:
    return -batch_mean(reconstruction_loss(recon_loss, in_dim, x,
                                           x_reconstr))


def vae_loss(recon_loss: str, in_dim, x, x_reconstr, *args, **kwargs):
    """Standard VAE ELBO; args = (z_mean, z_logsd)."""
    if len(args) != 2:
        raise ValueError(
            "Pass mean and SD values of encoded distribution as args")
    capacity = kwargs.get("capacity")
    kl_div = batch_mean(kld_normal(args))
    if capacity is not None:
        kl_div = infocapacity(kl_div, capacity,
                              num_iter=kwargs.get("num_iter", 0))
    return _likelihood(recon_loss, in_dim, x, x_reconstr) - kl_div


def _kl_rot_z(z_mean, z_logsd, phi_prior) -> torch.Tensor:
    """Rotation-prior KL of latent 0 plus the unit-normal KL of the rest."""
    kl_rot = batch_mean(kld_rot(phi_prior, z_logsd[:, 0]))
    return batch_mean(kld_normal([z_mean[:, 1:], z_logsd[:, 1:]])) + kl_rot


def rvae_loss(recon_loss: str, in_dim, x, x_reconstr, *args, **kwargs):
    """rVAE ELBO with the rotation prior; args = (z_mean, z_logsd)."""
    if len(args) != 2:
        raise ValueError(
            "Pass mean and SD values of encoded distribution as args")
    z_mean, z_logsd = args
    kl_div = _kl_rot_z(z_mean, z_logsd, kwargs.get("phi_prior", 0.1))
    capacity = kwargs.get("capacity")
    if capacity is not None:
        kl_div = infocapacity(kl_div, capacity,
                              num_iter=kwargs.get("num_iter", 0))
    return _likelihood(recon_loss, in_dim, x, x_reconstr) - kl_div


def _joint(likelihood, kl_cont, alphas, kwargs):
    cont_capacity = kwargs.get("cont_capacity", [5.0, 25000, 30])
    disc_capacity = kwargs.get("disc_capacity", [5.0, 25000, 30])
    kl_disc = torch.sum(torch.cat([kld_discrete(a) for a in alphas]))
    cont_cap_loss, disc_cap_loss = infocapacity(
        kl_cont, cont_capacity, kl_disc, disc_capacity,
        [a.shape[1] for a in alphas], kwargs.get("num_iter", 0))
    return likelihood - cont_cap_loss - disc_cap_loss


def joint_vae_loss(recon_loss: str, in_dim, x, x_reconstr, *args, **kwargs):
    """Joint continuous + discrete ELBO; args = (z_mean, z_logsd, alphas)."""
    if len(args) != 3:
        raise ValueError(
            "Pass continuous (mean, SD) and discrete (alphas) values "
            "of encoded distributions as args")
    z_mean, z_logsd, alphas = args
    return _joint(_likelihood(recon_loss, in_dim, x, x_reconstr),
                  batch_mean(kld_normal([z_mean, z_logsd])), alphas, kwargs)


def joint_rvae_loss(recon_loss: str, in_dim, x, x_reconstr, *args,
                    **kwargs):
    """Joint rotationally invariant ELBO; args = (z_mean, z_logsd,
    alphas)."""
    if len(args) != 3:
        raise ValueError(
            "Pass continuous (mean, SD) and discrete (alphas) values "
            "of encoded distributions as args")
    z_mean, z_logsd, alphas = args
    kl_cont = _kl_rot_z(z_mean, z_logsd, kwargs.get("phi_prior", 0.1))
    return _joint(_likelihood(recon_loss, in_dim, x, x_reconstr), kl_cont,
                  alphas, kwargs)


def _annealed(cap_max: float, num_iters, num_iter, ceiling: float):
    """min(cap_max * (num_iter / num_iters), ceiling) in float64: a number
    for a number ``num_iter``; for a tensor, clamped on its device and
    rounded to float32, the value the number takes in a float32 ELBO."""
    if isinstance(num_iter, torch.Tensor):
        return torch.clamp(cap_max * (num_iter.double() / float(num_iters)),
                           max=ceiling).float()
    return min(cap_max * (num_iter / float(num_iters)), ceiling)


def infocapacity(kl_cont_loss, cont_capacity: List[float],
                 kl_disc_loss=None, disc_capacity: Optional[List] = None,
                 disc_dims: Optional[List[int]] = None, num_iter=0):
    """Burgess capacity annealing: gamma * |KL - C(num_iter)|, with the
    capacity C rising linearly to its maximum over ``num_iters``
    (``num_iter`` a number or a 0-d tensor: module docstring)."""
    cont_max, cont_num_iters, cont_gamma = cont_capacity
    cont_cap = _annealed(cont_max, cont_num_iters, num_iter, cont_max)
    cont_capacity_loss = cont_gamma * torch.abs(kl_cont_loss - cont_cap)
    if kl_disc_loss is None:
        return cont_capacity_loss
    disc_max, disc_num_iters, disc_gamma = disc_capacity
    disc_theory_max = sum(float(np.log(d)) for d in disc_dims)
    disc_cap = _annealed(disc_max, disc_num_iters, num_iter,
                         min(disc_max, disc_theory_max))
    disc_capacity_loss = disc_gamma * torch.abs(disc_cap - kl_disc_loss)
    return cont_capacity_loss, disc_capacity_loss
