"""The plain reference of AtomAI's rotationally and translationally
invariant VAE (``rVAE``: https://github.com/pycroscopy/atomai,
``atomai/models/dgm/rvae.py``, ``atomai/nets/ed.py`` ``fcEncoderNet``,
``coord_latent``, ``rDecoderNet``, ``atomai/losses_metrics/vi_losses.py``
``rvae_loss``; the spatial decoder after Bepler et al., arXiv:1909.11663).

- ``fcEncoderNet``: the flattened image through ``num_layers`` of (Linear,
  tanh), then the heads ``fc11`` (latent means) and ``fc12`` (latent log
  standard deviations); the latents are the angle, the two shifts and the
  content latents.
- The reparameterisation z = mean + exp(log_sd) * eps with a given eps.
- The pixel grid (``imcoordgrid``: x from -1 to 1 down the rows, y from 1
  to -1 along the columns), rotated per sample by z[:, 0] (rows [cos, sin]
  and [-sin, cos], the grid's rows times it) and shifted by
  ``translation_prior`` * z[:, 1:3].
- ``rDecoderNet``: ``coord_latent`` (fc_coord of the coordinates plus the
  bias-free fc_latent of the content latents, broadcast over the pixels,
  tanh), ``num_layers`` of (Linear, tanh), the linear head ``out``.
- ``rvae_loss`` with ``mse``: the ELBO is -(the batch mean of half the
  summed squared error) - (the batch mean of ``kld_rot(phi_prior, .)`` of
  the angle's log-sd) - (the batch mean of ``kld_normal`` of the other
  latents).

Parameters are one dict under the port's (and AtomAI's) ``state_dict``
names, prefixed ``encoder.`` and ``decoder.``, in ``nn.Linear``'s (out, in)
layout. Gradients come from autograd, a step from ``weights.Adam``. Plain
torch in float32 with TF32 off (:func:`exact`). ``quant`` makes the
control: a (hidden, head) pair of dtypes to which each product's operands
are rounded, forward and backward (the hidden layers' and the decoder's
inputs and weights to the first, the float32 heads' to the second), the
products and sums in float32.

Departures from AtomAI, which the port shares (the JAX package it was
ported from made them) and the reference keeps, so that the comparison
judges one model:
- the grid's values are the correctly rounded ones (a float64 linspace
  cast once), where torch's float32 ``linspace`` may be an ulp off;
- the noise is an argument, where AtomAI draws it inside the model.
"""

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact():
    """cuBLAS and cuDNN without TF32 for the enclosed code."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def layer_names(num_layers: int = 2) -> List[str]:
    """Every Linear layer of the model, encoder first, as ``part.name``."""
    enc = [f"dense.{2 * i}" for i in range(num_layers)] + ["fc11", "fc12"]
    dec = ["coord_latent.fc_coord", "coord_latent.fc_latent"] + \
        [f"fc_decoder.{2 * i}" for i in range(num_layers)] + ["out"]
    return [f"encoder.{n}" for n in enc] + [f"decoder.{n}" for n in dec]


def init_params(in_dim: Tuple[int, int], latent_dim: int = 2,
                coord: int = 3, hidden: int = 128, num_layers: int = 2,
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
    shapes["decoder.coord_latent.fc_coord"] = (hidden, 2)
    shapes["decoder.coord_latent.fc_latent"] = (hidden, latent_dim)
    for i in range(num_layers):
        shapes[f"decoder.fc_decoder.{2 * i}"] = (hidden, hidden)
    shapes["decoder.out"] = (1, hidden)
    out = {}
    for name in layer_names(num_layers):
        o, i = shapes[name]
        bound = 1.0 / math.sqrt(i)
        out[name + ".weight"] = ((torch.rand(o, i, generator=generator) * 2
                                  - 1) * bound).to(device)
        if name != "decoder.coord_latent.fc_latent":
            out[name + ".bias"] = ((torch.rand(o, generator=generator) * 2
                                    - 1) * bound).to(device)
    return out


def grid(in_dim: Tuple[int, int], device="cpu") -> torch.Tensor:
    """(h*w, 2): x = linspace(-1, 1, h) down the rows, y = linspace(1, -1,
    w) along the columns."""
    xx = np.linspace(-1, 1, in_dim[0]).astype(np.float32)
    yy = np.linspace(1, -1, in_dim[1]).astype(np.float32)
    x0, x1 = np.meshgrid(xx, yy, indexing="ij")
    return torch.from_numpy(np.stack([x0.ravel(), x1.ravel()], 1)).to(device)


class _Round(torch.autograd.Function):
    """``t`` rounded to ``dtype`` and back, its gradient too."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else _Round.apply(t, dtype)


def _linear(p: Params, name: str, x: torch.Tensor, dtype=None
            ) -> torch.Tensor:
    y = _q(x, dtype) @ _q(p[name + ".weight"], dtype).T
    b = p.get(name + ".bias")
    return y if b is None else y + b


def encode(p: Params, x: torch.Tensor, num_layers: int = 2,
           quant: Optional[Sequence] = None) -> Tuple[torch.Tensor, ...]:
    """(z_mean, z_logsd) of the (B, h, w) images ``x``."""
    hid, head = quant if quant is not None else (None, None)
    h = x.reshape(x.shape[0], -1)
    for i in range(num_layers):
        h = torch.tanh(_linear(p, f"encoder.dense.{2 * i}", h, hid))
    return _linear(p, "encoder.fc11", h, head), \
        _linear(p, "encoder.fc12", h, head)


def transformed_grid(xy: torch.Tensor, z: torch.Tensor, dx_prior: float
                     ) -> torch.Tensor:
    """The grid (n, 2) of each sample rotated by z[:, 0] and shifted by
    ``dx_prior`` * z[:, 1:3]: (B, n, 2)."""
    phi = z[:, 0]
    c, s = torch.cos(phi), torch.sin(phi)
    rot = torch.stack([torch.stack([c, s], 1), torch.stack([-s, c], 1)], 1)
    coords = torch.bmm(xy.expand(z.shape[0], *xy.shape), rot)
    return coords + (z[:, 1:3] * dx_prior)[:, None, :]


def decode(p: Params, coords: torch.Tensor, z: torch.Tensor,
           num_layers: int = 2, quant: Optional[Sequence] = None
           ) -> torch.Tensor:
    """(B, n) of the spatial decoder at the (B, n, 2) coordinates with the
    (B, latent) content latents."""
    hid, head = quant if quant is not None else (None, None)
    h = _linear(p, "decoder.coord_latent.fc_coord", coords) + \
        _linear(p, "decoder.coord_latent.fc_latent", z, head)[:, None, :]
    h = torch.tanh(h)
    for i in range(num_layers):
        h = torch.tanh(_linear(p, f"decoder.fc_decoder.{2 * i}", h, hid))
    return _linear(p, "decoder.out", h, hid)[..., 0]


def kld_rot(phi_prior: float, phi_logsd: torch.Tensor) -> torch.Tensor:
    return (-phi_logsd + math.log(phi_prior)
            + torch.exp(phi_logsd) ** 2 / (2 * phi_prior ** 2) - 0.5)


def kld_normal(mu: torch.Tensor, log_sd: torch.Tensor) -> torch.Tensor:
    return torch.sum(-log_sd + 0.5 * torch.exp(log_sd) ** 2
                     + 0.5 * mu ** 2 - 0.5, -1)


def loss_from_latents(p: Params, x: torch.Tensor, z_mean: torch.Tensor,
                      z_logsd: torch.Tensor, eps: torch.Tensor,
                      xy: torch.Tensor, dx_prior: float, phi_prior: float,
                      num_layers: int = 2, quant=None) -> torch.Tensor:
    """-ELBO of the batch ``x`` given its encoder's outputs."""
    z = z_mean + torch.exp(z_logsd) * eps
    y = decode(p, transformed_grid(xy, z, dx_prior), z[:, 3:], num_layers,
               quant)
    rec = 0.5 * torch.sum((y - x.reshape(x.shape[0], -1)) ** 2, 1).mean()
    kl = kld_rot(phi_prior, z_logsd[:, 0]).mean() + \
        kld_normal(z_mean[:, 1:], z_logsd[:, 1:]).mean()
    return rec + kl


def loss(p: Params, x: torch.Tensor, eps: torch.Tensor, xy: torch.Tensor,
         dx_prior: float, phi_prior: float, num_layers: int = 2,
         quant=None) -> torch.Tensor:
    """-ELBO of the (B, h, w) batch ``x`` with the (B, 5) noise ``eps``."""
    z_mean, z_logsd = encode(p, x, num_layers, quant)
    return loss_from_latents(p, x, z_mean, z_logsd, eps, xy, dx_prior,
                             phi_prior, num_layers, quant)
