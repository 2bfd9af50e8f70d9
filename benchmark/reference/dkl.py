"""The plain reference of AtomAI's deep-kernel-learning GP regression
(``dklGPR``: https://github.com/pycroscopy/atomai, ``atomai/nets/gp.py``,
``atomai/models/dklgp/dklgpr.py``): a fully connected feature extractor,
a min-max scaling of its embedding, an exact GP with an ARD-RBF kernel, a
constant mean and Gaussian noise; ``fit`` minimises the negative exact
marginal log-likelihood (MLL), ``thompson`` takes one posterior draw over
the candidates and its argmax.

Plain torch, one output (``embedim`` = 2, one target), weights as a list
of (weight (out, in), bias (out,)) pairs in ``nn.Linear``'s layout, GP
hyperparameters raw (``raw_lengthscale`` (d,), ``raw_outputscale``,
``raw_noise``, ``mean_const``). It runs in the dtype it is given, with
TF32 off (:func:`exact`). ``quant`` (a dtype) makes the extractor the
control: each layer's input and weight rounded to it, the products and
sums in float32.

Departures from AtomAI's gpytorch model, which the port shares (the JAX
package it was ported from made them) and the reference keeps, so that
the comparison judges one model:
- the embedding is scaled per dimension to [-1, 1] by the min and max of
  the training embedding, and candidates by the same statistics;
- the kernel matrix of the training points carries a fixed jitter of 1e-5
  beside the noise (softplus(raw) + 1e-4, gpytorch's noise floor), where
  gpytorch adds jitter only when a factorisation fails;
- the draw forms the candidates' exact posterior covariance and
  factorises it with 1e-6 on its diagonal, where gpytorch samples through
  its own posterior object.
The squared distances are summed per dimension from differences, not
expanded into norms and a cross product as the port's kernel does.
"""

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

WIDTHS = (1000, 500, 50)    # fcFeatureExtractor's hidden widths
NOISE_FLOOR = 1e-4
JITTER = 1e-5               # on the training kernel matrix
DRAW_JITTER = 1e-6          # on the draw's posterior covariance

Weights = List[Tuple[torch.Tensor, torch.Tensor]]


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


def init_weights(indim: int, embedim: int, generator: torch.Generator,
                 widths: Sequence[int] = WIDTHS, device="cpu") -> Weights:
    """Layers indim -> widths -> embedim, weight and bias drawn from
    U(+-1/sqrt(fan_in)) (torch's default ``nn.Linear`` init)."""
    dims = [indim, *widths, embedim]
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(a)
        w = (torch.rand(b, a, generator=generator) * 2 - 1) * bound
        c = (torch.rand(b, generator=generator) * 2 - 1) * bound
        out.append((w.to(device), c.to(device)))
    return out


def init_gp(embedim: int, device="cpu") -> dict:
    """Raw hyperparameters at zero, as AtomAI's model starts."""
    z = torch.zeros((), device=device)
    return {"raw_lengthscale": torch.zeros(embedim, device=device),
            "raw_outputscale": z.clone(), "raw_noise": z.clone(),
            "mean_const": z.clone()}


def _rounded(t: torch.Tensor, quant: Optional[torch.dtype]) -> torch.Tensor:
    return t if quant is None else t.to(quant).to(t.dtype)


def extract(weights: Weights, x: torch.Tensor,
            quant: Optional[torch.dtype] = None,
            inputs: Optional[list] = None) -> torch.Tensor:
    """The extractor: Linear layers with a ReLU between each two.
    ``inputs``, a list, receives each layer's input."""
    for i, (w, b) in enumerate(weights):
        if i:
            x = torch.relu(x)
        if inputs is not None:
            inputs.append(x)
        x = _rounded(x, quant) @ _rounded(w, quant).T + b
    return x


@torch.no_grad()
def extract_grads(weights: Weights, inputs: Sequence[torch.Tensor],
                  grad: torch.Tensor, quant: Optional[torch.dtype] = None):
    """The extractor's backward at given activations: each layer's (weight,
    bias) gradient for ``grad`` at the output, ``inputs`` each layer's
    input (a layer's ReLU mask is where the next layer's input is
    positive); and the gradient at each layer's output. Operands rounded
    to ``quant`` for the control."""
    grads, outs = [], []
    d = grad
    for i in range(len(weights) - 1, -1, -1):
        outs.append(d)
        grads.append((_rounded(d, quant).T @ _rounded(inputs[i], quant),
                      d.sum(0)))
        if i:
            d = (_rounded(d, quant) @ _rounded(weights[i][0], quant)) * \
                (inputs[i] > 0)
    return grads[::-1], outs[::-1]


def bounds(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training embedding's per-dimension min and max."""
    return z.amin(0), z.amax(0)


def scale(z: torch.Tensor, stats) -> torch.Tensor:
    """Min-max scaling into [-1, 1] by the training statistics."""
    lo, hi = stats
    return -1.0 + 2.0 * (z - lo) / torch.clamp(hi - lo, min=1e-8)


def hyper(gp: dict, dtype=None):
    """(lengthscale (d,), outputscale, noise, mean), constrained in
    ``dtype`` (the raw parameters' own by default)."""
    gp = {k: v if dtype is None else v.to(dtype) for k, v in gp.items()}
    return (F.softplus(gp["raw_lengthscale"]),
            F.softplus(gp["raw_outputscale"]),
            F.softplus(gp["raw_noise"]) + NOISE_FLOOR, gp["mean_const"])


def rbf(z1: torch.Tensor, z2: torch.Tensor, ls: torch.Tensor,
        os_: torch.Tensor) -> torch.Tensor:
    """outputscale * exp(-0.5 sum_k ((z1_k - z2_k) / l_k)^2), (n, m)."""
    d2 = None
    for k in range(z1.shape[-1]):
        d = (z1[:, k, None] - z2[None, :, k]) / ls[k]
        d2 = d * d if d2 is None else d2.add_(d * d)
    return os_ * torch.exp(-0.5 * d2)


def _train_factor(z: torch.Tensor, ls, os_, noise) -> torch.Tensor:
    K = rbf(z, z, ls, os_)
    K.diagonal().add_(noise + JITTER)
    return torch.linalg.cholesky(K)


def gp_loss(z: torch.Tensor, gp: dict, y: torch.Tensor) -> torch.Tensor:
    """The exact negative MLL over N of the GP on the extractor's output
    ``z``, scaled by its own bounds."""
    z = scale(z, bounds(z))
    ls, os_, noise, mean = hyper(gp)
    L = _train_factor(z, ls, os_, noise)
    a = torch.linalg.solve_triangular(L, (y - mean)[:, None], upper=False)
    n = y.shape[0]
    return (0.5 * torch.sum(a * a) + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * n * math.log(2 * math.pi)) / n


def neg_mll(weights: Weights, gp: dict, X: torch.Tensor, y: torch.Tensor,
            quant: Optional[torch.dtype] = None) -> torch.Tensor:
    """The training loss: :func:`gp_loss` of the extractor's output."""
    return gp_loss(extract(weights, X, quant), gp, y)


@torch.no_grad()
def posterior(z_train: torch.Tensor, y: torch.Tensor, z_cand: torch.Tensor,
              gp: dict, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent posterior's mean (M,) and covariance (M, M) at the
    candidates' embedding, formed in ``dtype`` from the given (scaled)
    embeddings and hyperparameters."""
    zt, zc, y = z_train.to(dtype), z_cand.to(dtype), y.to(dtype)
    ls, os_, noise, mean = hyper(gp, dtype)
    L = _train_factor(zt, ls, os_, noise)
    Ks = rbf(zt, zc, ls, os_)                                    # (N, M)
    alpha = torch.cholesky_solve((y - mean)[:, None], L)
    mean_s = mean + (Ks.T @ alpha)[:, 0]
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    del Ks
    cov = rbf(zc, zc, ls, os_)
    cov -= V.T @ V
    return mean_s, cov


@torch.no_grad()
def draw(mean: torch.Tensor, cov: torch.Tensor, eps: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean + L eps, the posterior standard deviation), with L the
    Cholesky factor of ``cov`` + 1e-6 I (``cov`` is changed in place); a
    draw of NaN where the factorisation fails."""
    cov.diagonal().add_(DRAW_JITTER)
    sd = torch.sqrt(torch.clamp(cov.diagonal(), min=0))
    L, info = torch.linalg.cholesky_ex(cov)
    if int(info) != 0:
        return torch.full_like(mean, float("nan")), sd
    return mean + L @ eps.to(L.dtype), sd
