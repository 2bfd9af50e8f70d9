"""GP modules: feature extractors and the kernels over raw hyperparameters.

Counterpart of `atomai_tpu/nets/gp.py`. The feature extractor is the
MLP 1000-500-50-embedim (`:23-36`); the kernels (ARD-RBF and Matern-5/2
with an output scale, softplus or interval constraints on the raw
parameters, `:62-137`) are plain functions on tensors with a leading
output-batch axis where the JAX package vmaps. The exact-GP and SGPR
linear algebra lives in `atomai_tpu_torch/trainers/gptrainer.py`.

Shapes follow the JAX functions: ``x1`` (..., n, d), ``x2`` (..., m, d),
``lengthscale`` (..., d), ``outputscale`` (...) -> (..., n, m). The
functions set no precision switch: the trainers run them with TF32 off
(``Precision.full().tf32_scope()``), forward and backward, since a TF32
cross term ``x1 @ x2^T`` corrupts the squared distances near the diagonal
and with them the Cholesky factor.
"""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _no_autocast(x: torch.Tensor):
    return torch.autocast(x.device.type, enabled=False)


class fcFeatureExtractor(nn.Module):
    """MLP feature extractor, Linear + ReLU (`atomai_tpu/nets/gp.py:23-36`).

    ``layers.i`` is flax's ``Dense_i``. It computes in float32 outside
    autocast, as the flax ``Dense`` without a ``dtype`` does; the caller's
    precision policy sets only its TF32 switch. Weights start at torch's
    default ``nn.Linear`` init, U(+-1/sqrt(fan_in)) for weight and bias,
    the distribution of the JAX package's ``init_kwargs``."""

    def __init__(self, feat_dim: int, embedim: int,
                 hidden_dim: Sequence[int] = (1000, 500, 50)):
        super().__init__()
        dims = [feat_dim, *hidden_dim, embedim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _no_autocast(x):
            for i, layer in enumerate(self.layers):
                if i:
                    x = torch.relu(x)
                x = layer(x)
        return x


class StackedFeatureExtractor(nn.Module):
    """``n_members`` fc extractors with their weights stacked on a leading
    member axis: ``kernels.i`` (b, in, out) (flax's ``Dense_i`` kernel
    layout) and ``biases.i`` (b, out). ``forward`` maps the shared inputs
    (N, in) to (b, N, out) with one ``torch.baddbmm`` a layer: the
    counterpart of ``jax.vmap`` over stacked ``fe_params``
    (`atomai_tpu/trainers/gptrainer.py:426-445`). Float32, outside
    autocast, like :class:`fcFeatureExtractor`."""

    def __init__(self, n_members: int, feat_dim: int, embedim: int,
                 hidden_dim: Sequence[int] = (1000, 500, 50)):
        super().__init__()
        dims = [feat_dim, *hidden_dim, embedim]
        self.kernels = nn.ParameterList(
            nn.Parameter(torch.zeros(n_members, a, b))
            for a, b in zip(dims[:-1], dims[1:]))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(n_members, b)) for b in dims[1:])

    @classmethod
    def from_members(cls, members: Sequence[fcFeatureExtractor]
                     ) -> "StackedFeatureExtractor":
        """The members' weights stacked (Linear (out, in) -> (in, out))."""
        dims = [members[0].layers[0].in_features] + [
            layer.out_features for layer in members[0].layers]
        out = cls(len(members), dims[0], dims[-1], dims[1:-1])
        with torch.no_grad():
            for i, (k, b) in enumerate(zip(out.kernels, out.biases)):
                k.copy_(torch.stack([m.layers[i].weight.T for m in members]))
                b.copy_(torch.stack([m.layers[i].bias for m in members]))
        return out

    def forward(self, x: torch.Tensor, members: slice = slice(None)
                ) -> torch.Tensor:
        """(N, in) -> (b, N, out), or the outputs of the ``members`` slice
        of the stack alone."""
        with _no_autocast(x):
            x = x.expand(self.kernels[0][members].shape[0], *x.shape)
            for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
                if i:
                    x = torch.relu(x)
                x = torch.baddbmm(b[members, None, :], x, k[members])
        return x


class MemberStack(nn.Module):
    """A user-given extractor in ``n`` copies: (N, in) -> (n, N, out), one
    member after another (or those of the ``members`` slice alone)."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(members)

    def forward(self, x: torch.Tensor, members: slice = slice(None)
                ) -> torch.Tensor:
        return torch.stack([m(x) for m in self.members[members]])


def compute_bounds_stats(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dim min/max over the point axis: the train-time statistics of
    gpytorch's ScaleToBounds. ``amin``/``amax`` spread the gradient evenly
    over ties, as ``jnp.min``/``jnp.max`` do."""
    return (torch.amin(x, dim=-2, keepdim=True),
            torch.amax(x, dim=-2, keepdim=True))


def scale_to_bounds(x: torch.Tensor, lb: float = -1.0, ub: float = 1.0,
                    eps: float = 1e-8, stats=None) -> torch.Tensor:
    """Min-max scales features into [lb, ub]. ``stats``: the (xmin, xmax)
    of the training embedding (:func:`compute_bounds_stats`), so that
    test and candidate embeddings share the training transform; ``None``
    scales by ``x``'s own."""
    xmin, xmax = compute_bounds_stats(x) if stats is None else stats
    x01 = (x - xmin) / torch.maximum(xmax - xmin, x.new_tensor(eps))
    return lb + (ub - lb) * x01


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def inv_softplus(y) -> torch.Tensor:
    y = torch.as_tensor(y, dtype=torch.float32)
    return torch.log(torch.expm1(torch.clamp_min(y, 1e-6)))


def constrain(raw: torch.Tensor, lower=None, upper=None) -> torch.Tensor:
    """Positive (softplus) or interval (sigmoid-scaled) transform."""
    if lower is None and upper is None:
        return softplus(raw)
    lower = 0.0 if lower is None else lower
    return lower + (upper - lower) * torch.sigmoid(raw)


def sq_dist(x1: torch.Tensor, x2: torch.Tensor,
            lengthscale: torch.Tensor) -> torch.Tensor:
    """Scaled squared distance ||x1/l - x2/l||^2, (..., n, d), (..., m, d)
    -> (..., n, m), clipped at 0 with ``torch.maximum`` (whose gradient
    splits ties, as ``jnp.maximum``'s does)."""
    x1 = x1 / lengthscale
    x2 = x2 / lengthscale
    x1n = torch.sum(x1 * x1, dim=-1, keepdim=True)
    x2n = torch.sum(x2 * x2, dim=-1, keepdim=True)
    cross = x1 @ x2.transpose(-1, -2)
    d2 = x1n - 2.0 * cross + x2n.transpose(-1, -2)
    return torch.maximum(d2, d2.new_zeros(()))


def rbf_kernel(x1, x2, lengthscale, outputscale):
    """ARD-RBF: outputscale * exp(-0.5 * d2)."""
    return outputscale[..., None, None] * torch.exp(
        -0.5 * sq_dist(x1, x2, lengthscale[..., None, :]))


def matern52_kernel(x1, x2, lengthscale, outputscale):
    """ARD Matern-5/2 (gpytorch's MaternKernel default nu=2.5)."""
    d = torch.sqrt(sq_dist(x1, x2, lengthscale[..., None, :]) + 1e-12)
    s5d = 5.0 ** 0.5 * d
    k = (1.0 + s5d + (5.0 / 3.0) * d * d) * torch.exp(-s5d)
    return outputscale[..., None, None] * k


KERNELS = {"rbf": rbf_kernel, "matern": matern52_kernel}


def kernel_diag(kernel: Callable, X: torch.Tensor, lengthscale: torch.Tensor,
                outputscale: torch.Tensor) -> torch.Tensor:
    """diag(kernel(X, X)) without the n x n matrix: shape
    ``outputscale.shape + (n,)``. The built-in stationary kernels have the
    outputscale on their diagonal; a user's kernel callable is evaluated
    point by point (each point its own batch entry)."""
    n = X.shape[-2]
    if kernel in (rbf_kernel, matern52_kernel):
        return outputscale[..., None].expand(outputscale.shape + (n,))
    Xp = X[..., :, None, :]                          # (..., n, 1, d)
    return kernel(Xp, Xp, lengthscale[..., None, :],
                  outputscale[..., None])[..., 0, 0]


def init_gp_params(input_dim: int, batch_shape: Tuple[int, ...] = (),
                   device=None) -> dict:
    """Raw GP hyperparameters (ARD lengthscales, outputscale, noise, mean),
    zeros: softplus(0) ~ 0.693 for the constrained values."""
    return {
        "raw_lengthscale": torch.zeros(batch_shape + (input_dim,),
                                       device=device),
        "raw_outputscale": torch.zeros(batch_shape, device=device),
        "raw_noise": torch.zeros(batch_shape, device=device),
        "mean_const": torch.zeros(batch_shape, device=device),
    }


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """numpy, JAX or torch data as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=dtype, device=device)


class GPRegressionModel:
    """DKL GP bundle (counterpart of `atomai_tpu/nets/gp.py:140-203`):
    feature extractor, ARD-RBF kernel and constant mean, with explicit
    parameters ``{"fe": {name: tensor}, "gp": {raw GP params}}``; the
    extractor runs through ``torch.func.functional_call`` on ``fe``.
    ``likelihood`` is accepted for signature parity (the noise is
    ``gp["raw_noise"]``); ``grid_size`` is stored, unused, as in the JAX
    package. ``device``: "cuda" (default; raises without a card) or
    "cpu"."""

    def __init__(self, X, y, likelihood=None,
                 feature_extractor: Optional[nn.Module] = None,
                 embedim: int = 2, grid_size: int = 50,
                 device="cuda") -> None:
        from ..core.device import resolve_device
        self.device = resolve_device(device)
        self.X = _as_tensor(X, self.device)
        y = _as_tensor(y, self.device)
        self.y = y if y.ndim == 2 else y[None]
        self.batch_dim = self.y.shape[0]
        self.embedim = embedim
        self.grid_size = grid_size
        self.feature_extractor = (feature_extractor or fcFeatureExtractor(
            self.X.shape[-1], embedim)).to(self.device)
        self.kernel = rbf_kernel

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """{"fe": ..., "gp": ...}: the extractor's weights drawn from
        ``generator`` (a host generator; seed 0 when None), GP
        hyperparameters with a leading output-batch axis."""
        from ..core.prng import generator_from_seed
        from .blocks import init_weights_
        init_weights_(self.feature_extractor,
                      generator or generator_from_seed(0))
        fe = {k: v.detach().clone() for k, v in
              self.feature_extractor.named_parameters()}
        gp = init_gp_params(self.embedim, (self.batch_dim,), self.device)
        return {"fe": fe, "gp": gp}

    def _fe(self, params, x):
        return torch.func.functional_call(self.feature_extractor,
                                          params["fe"], (x,))

    def train_stats(self, params):
        """ScaleToBounds statistics of ``params``' training embedding."""
        return compute_bounds_stats(self._fe(params, self.X))

    def embed(self, params, x, stats=None):
        return scale_to_bounds(
            self._fe(params, x),
            stats=self.train_stats(params) if stats is None else stats)

    def forward(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """GP prior (mean (b, n), cov (b, n, n)) at the embedded inputs."""
        from ..trainers.gptrainer import _hyp
        emb = self.embed(params, _as_tensor(x, self.device))
        ls, os_, _, _ = _hyp(params["gp"])
        cov = self.kernel(emb[None], emb[None], ls, os_)
        mean = params["gp"]["mean_const"][:, None].expand(
            self.batch_dim, emb.shape[0])
        return mean, cov

    __call__ = forward


class CustomGPModel:
    """Configurable GP (counterpart of `atomai_tpu/nets/gp.py:206-268`):
    kernel 'rbf', 'matern' or a callable; ``kernel_type`` 'exact',
    'sparse' (explicit ``inducing_points``) or 'kissgp' (an inducing grid
    over the inputs' bounding box); optional lengthscale interval
    constraints. ``device``: "cuda" (default; raises without a card) or
    "cpu"."""

    def __init__(self, train_x, train_y, likelihood=None,
                 kernel_type: str = "kissgp", base_kernel="rbf",
                 inducing_points=None, grid_points_ratio: float = 1.0,
                 lengthscale_constraints=None, device="cuda",
                 **kwargs) -> None:
        from ..core.device import resolve_device
        self.device = resolve_device(device)
        self.X = _as_tensor(train_x, self.device)
        self.y = _as_tensor(train_y, self.device)
        if isinstance(base_kernel, str):
            if base_kernel not in KERNELS:
                raise ValueError(
                    "base_kernel must be 'rbf', 'matern', or a callable")
            base_kernel = KERNELS[base_kernel]
        self.kernel = base_kernel
        self.kernel_type = kernel_type
        self.lengthscale_constraints = lengthscale_constraints
        if kernel_type == "sparse":
            if inducing_points is None:
                raise ValueError(
                    "kernel_type='sparse' requires inducing_points")
            self.Z = _as_tensor(inducing_points, self.device)
        elif kernel_type == "kissgp":
            from ..trainers.gptrainer import make_inducing_grid
            self.Z = make_inducing_grid(self.X, grid_points_ratio)
        else:
            self.Z = None

    def init(self) -> dict:
        return init_gp_params(self.X.shape[-1], device=self.device)

    def neg_mll(self, params) -> torch.Tensor:
        from ..trainers import gptrainer as gt
        if self.Z is not None:
            return gt.neg_mll_sparse(params, self.X, self.y, self.Z,
                                     self.kernel,
                                     self.lengthscale_constraints)
        return gt.neg_mll(params, self.X, self.y, self.kernel,
                          self.lengthscale_constraints)

    def posterior(self, params, Xs, full_cov: bool = False):
        from ..trainers import gptrainer as gt
        Xs = _as_tensor(Xs, self.device)
        if self.Z is not None:
            cache = gt.sparse_posterior_cache(
                params, self.X, self.y, self.Z, self.kernel,
                self.lengthscale_constraints)
            return gt.sparse_posterior(cache, Xs, self.kernel)
        return gt.posterior(params, self.X, self.y, Xs, self.kernel,
                            self.lengthscale_constraints, full_cov)

    def forward(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """GP prior (mean, cov) at x."""
        from ..trainers.gptrainer import _hyp
        x = _as_tensor(x, self.device)
        ls, os_, _, _ = _hyp(params, self.lengthscale_constraints)
        cov = self.kernel(x, x, ls[None], os_[None])[0]
        mean = params["mean_const"].expand(x.shape[0])
        return mean, cov

    __call__ = forward
