"""Losses of the VAE family."""

from .vi_losses import (infocapacity, joint_rvae_loss, joint_vae_loss,
                        kld_discrete, kld_normal, kld_rot,
                        reconstruction_loss, rvae_loss, vae_loss)

__all__ = ["reconstruction_loss", "kld_normal", "kld_discrete", "kld_rot",
           "vae_loss", "rvae_loss", "joint_vae_loss", "joint_rvae_loss",
           "infocapacity"]
