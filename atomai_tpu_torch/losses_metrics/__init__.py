"""Losses and metrics: the supervised losses, IoU, and the VAE family's
ELBO terms."""

from .losses import (MultiTaskLoss, ce_loss, dice_loss, focal_loss,
                     mse_loss, multitask_loss, nll_loss, select_loss)
from .metrics import IoU, iou_score
from .vi_losses import (infocapacity, joint_rvae_loss, joint_vae_loss,
                        kld_discrete, kld_normal, kld_rot,
                        reconstruction_loss, rvae_loss, vae_loss)

__all__ = ["focal_loss", "dice_loss", "ce_loss", "nll_loss", "mse_loss",
           "multitask_loss", "MultiTaskLoss", "select_loss", "iou_score",
           "IoU", "reconstruction_loss", "kld_normal", "kld_discrete",
           "kld_rot", "vae_loss", "rvae_loss", "joint_vae_loss",
           "joint_rvae_loss", "infocapacity"]
