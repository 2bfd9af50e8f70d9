"""The plain reference of AtomAI's joint rotationally and translationally
invariant VAE with the generative-skip decoder (``jrVAE(..., skip=True)``:
https://github.com/pycroscopy/atomai, ``atomai/models/dgm/jrvae.py``;
``atomai/nets/ed.py`` ``jfcEncoderNet``, ``coord_latent``,
``rDecoderNet(skip=True)``; ``atomai/losses_metrics/vi_losses.py``
``joint_rvae_loss``, ``kld_discrete``, ``infocapacity``; the generative
skip model of Dieng et al., arXiv:1807.04863).

- ``jfcEncoderNet``: the flattened image through ``num_layers`` of
  (Linear, tanh), then the heads ``fc11`` (the continuous latents' means),
  ``fc12`` (their log standard deviations) and one ``fc13.{k}`` a discrete
  latent, each through a softmax (its ``alpha``). The continuous latents
  are the angle, the two shifts and the content latents.
- The continuous sample z = mean + exp(log_sd) * eps; each discrete
  latent's Gumbel-softmax sample softmax((log(alpha + 1e-12) + g) / tau),
  g = -log(-log(u + 1e-12) + 1e-12), from given eps and uniforms u.
- The pixel grid rotated by z[:, 0] and shifted by ``translation_prior``
  * z[:, 1:3] (``rvae.transformed_grid``).
- ``rDecoderNet(skip=True)``: h0 = fc_coord(coords) + fc_latent(latents)
  broadcast over the pixels, with no tanh (``coord_latent`` without its
  activation); h_l = tanh(fc_decoder.{2(l-1)}(h_(l-1))) + h0; the linear
  head ``out``. The latents are z[:, 3:] and the discrete samples.
  Computed in blocks of samples (``block``), the same arithmetic row by
  row with a bounded working set.
- ``joint_rvae_loss`` with ``mse``: the ELBO is -(the batch mean of half
  the summed squared error) - gamma_c |KL_c - C_c(t)| - gamma_d |KL_d -
  C_d(t)|: KL_c the batch mean of ``kld_rot(phi_prior, .)`` of the
  angle's log-sd plus that of ``kld_normal`` of the other continuous
  latents; KL_d the heads' summed batch means of sum(alpha (log(alpha +
  1e-12) - log(1 / k + 1e-12))); C(t) = min(max t / iters, max) for
  [max, iters, gamma] (and at most the heads' sum of log k for C_d).
- The step count t of a step: the fit's epochs done times its steps an
  epoch plus the step's place in its epoch (:func:`step_count`).

Parameters are one dict under the port's (and AtomAI's) ``state_dict``
names, prefixed ``encoder.`` and ``decoder.``, in ``nn.Linear``'s (out, in)
layout. Gradients come from autograd. Plain torch in float32 with TF32
off (``rvae.exact``). ``quant`` makes the control, as ``rvae.py``'s: a
(hidden, head) pair of dtypes to which each product's operands are
rounded, forward and backward (the hidden layers' and the decoder's
inputs and weights to the first, the float32 heads' and ``fc_latent``'s
to the second).

Departures from AtomAI, which the port shares (the JAX package it was
ported from made them) and the reference keeps, so that the comparison
judges one model:
- the decoder takes latent_dim + sum(discrete_dim) latents (AtomAI's
  jrVAE the same; the port's sizing adds ``nb_classes``, 0 here);
- the grid's values are the correctly rounded ones, as ``rvae.py``'s;
- the noise and the uniforms are arguments, where AtomAI draws them
  inside the model, and the step count is one, where AtomAI counts it on
  the trainer.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference import rvae

Params = Dict[str, torch.Tensor]
EPS = 1e-12
exact = rvae.exact
grid = rvae.grid
transformed_grid = rvae.transformed_grid
kld_rot = rvae.kld_rot
kld_normal = rvae.kld_normal


def layer_names(num_layers: int = 2, heads: int = 1) -> List[str]:
    """Every Linear layer of the model, encoder first, as ``part.name``."""
    enc = [f"dense.{2 * i}" for i in range(num_layers)] + ["fc11", "fc12"] \
        + [f"fc13.{k}" for k in range(heads)]
    dec = ["coord_latent.fc_coord", "coord_latent.fc_latent"] + \
        [f"fc_decoder.{2 * i}" for i in range(num_layers)] + ["out"]
    return [f"encoder.{n}" for n in enc] + [f"decoder.{n}" for n in dec]


def init_params(in_dim: Tuple[int, int], latent_dim: int = 2,
                coord: int = 3, discrete_dim: Sequence[int] = (2,),
                hidden: int = 128, num_layers: int = 2,
                generator: Optional[torch.Generator] = None, device="cpu"
                ) -> Params:
    """Weights and biases drawn from U(+-1/sqrt(fan_in)) (torch's default
    ``nn.Linear`` init), layer by layer in :func:`layer_names`' order."""
    n_in = int(np.prod(in_dim))
    z = latent_dim + coord
    shapes = {}
    for i in range(num_layers):
        shapes[f"encoder.dense.{2 * i}"] = (hidden, n_in if i == 0 else hidden)
    shapes["encoder.fc11"] = shapes["encoder.fc12"] = (z, hidden)
    for k, d in enumerate(discrete_dim):
        shapes[f"encoder.fc13.{k}"] = (d, hidden)
    shapes["decoder.coord_latent.fc_coord"] = (hidden, 2)
    shapes["decoder.coord_latent.fc_latent"] = (hidden, latent_dim
                                                + sum(discrete_dim))
    for i in range(num_layers):
        shapes[f"decoder.fc_decoder.{2 * i}"] = (hidden, hidden)
    shapes["decoder.out"] = (1, hidden)
    out = {}
    for name in layer_names(num_layers, len(discrete_dim)):
        o, i = shapes[name]
        bound = 1.0 / math.sqrt(i)
        out[name + ".weight"] = ((torch.rand(o, i, generator=generator) * 2
                                  - 1) * bound).to(device)
        if name != "decoder.coord_latent.fc_latent":
            out[name + ".bias"] = ((torch.rand(o, generator=generator) * 2
                                    - 1) * bound).to(device)
    return out


def heads(p: Params) -> int:
    """The number of discrete latents the parameters carry."""
    return sum(1 for k in p if k.startswith("encoder.fc13.")
               and k.endswith(".weight"))


def encode(p: Params, x: torch.Tensor, num_layers: int = 2,
           quant: Optional[Sequence] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(z_mean, z_logsd, [alpha of each discrete latent]) of the (B, h, w)
    images ``x``."""
    hid, head = quant if quant is not None else (None, None)
    h = x.reshape(x.shape[0], -1)
    for i in range(num_layers):
        h = torch.tanh(rvae._linear(p, f"encoder.dense.{2 * i}", h, hid))
    alphas = [torch.softmax(rvae._linear(p, f"encoder.fc13.{k}", h, head), 1)
              for k in range(heads(p))]
    return rvae._linear(p, "encoder.fc11", h, head), \
        rvae._linear(p, "encoder.fc12", h, head), alphas


def gumbel_softmax(alpha: torch.Tensor, u: torch.Tensor, tau: float
                   ) -> torch.Tensor:
    """The Gumbel-softmax sample of ``alpha`` (B, k) for the uniforms
    ``u`` at temperature ``tau``."""
    g = -torch.log(-torch.log(u + EPS) + EPS)
    return torch.softmax((torch.log(alpha + EPS) + g) / tau, 1)


def decode(p: Params, coords: torch.Tensor, z: torch.Tensor,
           num_layers: int = 2, quant: Optional[Sequence] = None,
           block: int = 25) -> torch.Tensor:
    """(B, n) of the skip decoder at the (B, n, 2) coordinates with the
    (B, latents) decoder latents, ``block`` samples at a time."""
    hid, head = quant if quant is not None else (None, None)
    out = []
    for s in range(0, coords.shape[0], block):
        c, zs = coords[s:s + block], z[s:s + block]
        h0 = rvae._linear(p, "decoder.coord_latent.fc_coord", c) + \
            rvae._linear(p, "decoder.coord_latent.fc_latent", zs,
                         head)[:, None, :]
        h = h0
        for i in range(num_layers):
            h = torch.tanh(rvae._linear(p, f"decoder.fc_decoder.{2 * i}", h,
                                        hid)) + h0
        out.append(rvae._linear(p, "decoder.out", h, hid)[..., 0])
    return torch.cat(out)


def kld_discrete(alpha: torch.Tensor) -> torch.Tensor:
    """The batch mean of the KL of ``alpha`` against a uniform
    categorical."""
    h2 = math.log(1.0 / alpha.shape[-1] + EPS)
    return torch.sum(alpha * (torch.log(alpha + EPS) - h2), 1).mean()


def capacity(schedule: Sequence[float], t: int,
             ceiling: Optional[float] = None) -> float:
    """C(t) = min(max * t / iters, max[, ceiling]) of [max, iters, gamma],
    in float64."""
    cap_max, iters, _ = schedule
    c = min(cap_max * (t / float(iters)), cap_max)
    return c if ceiling is None else min(c, ceiling)


def step_count(epochs_done: int, steps_per_epoch: int, step: int) -> int:
    """The step count of the ``step``-th step of an epoch after
    ``epochs_done`` whole epochs."""
    return epochs_done * steps_per_epoch + step


def loss_from_latents(p: Params, x: torch.Tensor, z_mean: torch.Tensor,
                      z_logsd: torch.Tensor, alphas: Sequence[torch.Tensor],
                      eps: torch.Tensor, u: Sequence[torch.Tensor],
                      xy: torch.Tensor, fit: dict, t: int,
                      num_layers: int = 2, quant=None) -> torch.Tensor:
    """-ELBO of the batch ``x`` given its encoder's outputs, at the step
    count ``t``; ``fit`` holds ``translation_prior``, ``rotation_prior``,
    ``temperature``, ``cont_capacity`` and ``disc_capacity``."""
    z = z_mean + torch.exp(z_logsd) * eps
    disc = [gumbel_softmax(a, uk, fit["temperature"])
            for a, uk in zip(alphas, u)]
    y = decode(p, transformed_grid(xy, z, fit["translation_prior"]),
               torch.cat([z[:, 3:]] + disc, 1), num_layers, quant)
    rec = 0.5 * torch.sum((y - x.reshape(x.shape[0], -1)) ** 2, 1).mean()
    kl_c = kld_rot(fit["rotation_prior"], z_logsd[:, 0]).mean() + \
        kld_normal(z_mean[:, 1:], z_logsd[:, 1:]).mean()
    kl_d = sum(kld_discrete(a) for a in alphas)
    c_c = capacity(fit["cont_capacity"], t)
    c_d = capacity(fit["disc_capacity"], t,
                   sum(math.log(a.shape[1]) for a in alphas))
    return rec + fit["cont_capacity"][2] * torch.abs(kl_c - c_c) \
        + fit["disc_capacity"][2] * torch.abs(c_d - kl_d)


def loss(p: Params, x: torch.Tensor, eps: torch.Tensor,
         u: Sequence[torch.Tensor], xy: torch.Tensor, fit: dict, t: int,
         num_layers: int = 2, quant=None) -> torch.Tensor:
    """-ELBO of the (B, h, w) batch ``x`` with the (B, 5) noise ``eps`` and
    each discrete latent's (B, k) uniforms ``u``, at the step count ``t``."""
    z_mean, z_logsd, alphas = encode(p, x, num_layers, quant)
    return loss_from_latents(p, x, z_mean, z_logsd, alphas, eps, u, xy, fit,
                             t, num_layers, quant)
