"""dklGPR: deep-kernel-learning GP regression.

Counterpart of `atomai_tpu/models/dklgp/dklgpr.py`: ``fit``,
``fit_ensemble`` (a replicated scalar target -> independent GPs), the
posterior with the training-side Cholesky factorised once per fit,
``sample_from_posterior``, Thompson sampling, batched ``predict`` and
``embed``. The posterior draws take their noise from the model's
generator stream, or from ``eps`` when the caller passes it.

The draws depart from the JAX package, which forms and factorises the
candidates' posterior covariance in float32 (`atomai_tpu/models/dklgp/
dklgpr.py:117-128`). Over thousands of candidates dense in the embedding,
``Kss - V^T V`` cancels to a matrix whose float32 rounding is larger than
the 1e-6 jitter, its Cholesky fails, and the JAX package draws NaN and
picks index 0. Here the draw's posterior is formed and factorised in
``DRAW_DTYPE``, float64, from the float32 embeddings and hyperparameters
and a float64 factor of the training points (``predict`` keeps the float32
one); where even that factorisation fails, the draw raises
``LinAlgError`` instead of returning NaN.
"""

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...core import profiling
from ...trainers.gptrainer import (_FULL, dklGPTrainer, posterior_cache,
                                   posterior_from_cache)

# the dtype the draws' posterior is formed and factorised in
DRAW_DTYPE = torch.float64
# added to the diagonal of the draws' posterior covariance
DRAW_JITTER = 1e-6


class dklGPR(dklGPTrainer):
    """DKL-GPR model. ``device``: "cuda" (default; raises without a card)
    or "cpu".

    Example:
        >>> dklgp = aoi.models.dklGPR(data_dim, embedim=2, device="cuda")
        >>> dklgp.fit(X, y, training_cycles=100, lr=1e-2)
        >>> mean, var = dklgp.predict(X_test)
        >>> obj, next_idx = dklgp.thompson(X_cand)
    """

    def __init__(self, indim: int, embedim: int = 2,
                 shared_embedding_space: bool = True, **kwargs):
        super().__init__(indim, embedim, shared_embedding_space, **kwargs)

    def fit(self, X, y, training_cycles: int = 1, **kwargs) -> None:
        """Initialises and trains the DKL-GP model."""
        self.run(X, y, training_cycles, **kwargs)

    def fit_ensemble(self, X, y, training_cycles: int = 1,
                     n_models: int = 5, **kwargs) -> None:
        """An ensemble of ``n_models`` independently initialised DKL models
        on a scalar target."""
        y = np.asarray(y)
        if y.ndim == 1:
            y = y[None]
        if y.shape[0] > 1:
            raise NotImplementedError(
                "The ensemble training is currently supported only for "
                "scalar targets")
        y = np.repeat(y, n_models, axis=0)
        if self.correlated_output:
            warnings.warn(
                "Replacing a single shared embedding space with {} "
                "independent ones".format(n_models))
            self.correlated_output = False
        self.ensemble = True
        self.run(X, y, training_cycles, **kwargs)

    def run(self, X=None, y=None, training_cycles: int = 1, **kwargs):
        self._post_cache = None
        return super().run(X, y, training_cycles, **kwargs)

    # --------------------------------------------------------- posterior
    @torch.no_grad()
    def _get_cache(self, dtype: torch.dtype = torch.float32):
        """(cache, training embedding) in ``dtype``: the factorisation of
        every output, computed once per fit and dtype from the float32
        embedding and hyperparameters."""
        if self._post_cache is None:
            self._post_cache = {}
        if dtype not in self._post_cache:
            z = self._embed(self.X, self.scale_stats).to(dtype)
            gp = {k: v.detach().to(dtype) for k, v in self.gp_params.items()}
            with _FULL.tf32_scope():
                cache = posterior_cache(gp, z, self.y.to(dtype), self.kernel)
            self._post_cache[dtype] = (cache, z)
        return self._post_cache[dtype]

    @torch.no_grad()
    def _posteriors(self, Xs: torch.Tensor):
        """Each output's posterior mean (b, M) and variance (b, M) at Xs."""
        cache, z_train = self._get_cache()
        z_s = self._embed(Xs, self.scale_stats)
        with _FULL.tf32_scope():
            return posterior_from_cache(cache, z_train, z_s, self.kernel)

    @torch.no_grad()
    def _draw_posterior(self, Xs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each output's posterior mean (b, M) and covariance (b, M, M) at
        Xs in ``DRAW_DTYPE``, ``DRAW_JITTER`` on the covariance's
        diagonal."""
        cache, z_train = self._get_cache(DRAW_DTYPE)
        z_s = self._embed(Xs, self.scale_stats).to(DRAW_DTYPE)
        with _FULL.tf32_scope():
            mean, cov = posterior_from_cache(cache, z_train, z_s, self.kernel,
                                             full_cov=True)
        cov.diagonal(dim1=-2, dim2=-1).add_(DRAW_JITTER)
        return mean, cov

    @torch.no_grad()
    def sample_from_posterior(self, X, num_samples: int = 1000,
                              eps: Optional[torch.Tensor] = None
                              ) -> np.ndarray:
        """(num_samples, b, M) float32 draws from the posterior at X, formed
        in ``DRAW_DTYPE``. ``eps``: the (num_samples, b, M) standard normal
        noise; drawn (in float32) from the model's generator stream when
        None. Raises ``torch.linalg.LinAlgError`` where the covariance does
        not factorise."""
        Xs, _ = self.set_data(X)
        if eps is not None:
            with profiling.span("dkl.upload"):
                eps = torch.as_tensor(eps, dtype=torch.float32,
                                      device=self.device)
        mean, cov = self._draw_posterior(Xs)
        b, M = mean.shape
        if eps is None:
            eps = torch.randn((num_samples, b, M), device=self.device,
                              generator=self.keys.next(device=self.device))
        with _FULL.tf32_scope():
            L, info = torch.linalg.cholesky_ex(cov)
            del cov
            samples = mean[None] + torch.einsum("bmn,sbn->sbm", L,
                                                eps.to(L.dtype))
        with profiling.span("dkl.fetch"):
            samples = samples.float().cpu().numpy()
            info = info.cpu()
        if bool(info.any()):
            raise torch.linalg.LinAlgError(
                f"the posterior covariance of {M} candidates is not "
                f"positive definite in {DRAW_DTYPE} (cholesky info "
                f"{info.tolist()}): candidates too close together in the "
                f"embedding")
        return samples

    def thompson(self, X_cand, scalarize_func: Optional[Callable] = None,
                 maximize: bool = True, eps: Optional[torch.Tensor] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Thompson sampling for the next measurement point: one posterior
        draw (``eps`` (1, b, M) as in :meth:`sample_from_posterior`) and its
        argmax (argmin); ``scalarize_func`` maps a multi-output draw
        (b, M) to one row."""
        with profiling.span("dkl.thompson"):
            tsample = self.sample_from_posterior(X_cand, 1, eps)[0]
            if tsample.ndim > 1 and scalarize_func is not None:
                tsample = np.asarray(scalarize_func(tsample))[None]
            idx = tsample.argmax(-1) if maximize else tsample.argmin(-1)
        return tsample, idx

    def predict(self, x_new, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance in batches of ``batch_size`` (all
        at once by default), fetched once."""
        x_new, _ = self.set_data(x_new)
        batch_size = kwargs.get("batch_size", len(x_new))
        outs = [self._posteriors(x_new[i:i + batch_size])
                for i in range(0, len(x_new), batch_size)]
        mean = torch.cat([m for m, _ in outs], -1).cpu().numpy()
        var = torch.cat([v for _, v in outs], -1).cpu().numpy()
        return mean.squeeze(), var.squeeze()

    @torch.no_grad()
    def _embed_new(self, x: torch.Tensor) -> torch.Tensor:
        emb = self._embed(x, self.scale_stats)
        return emb if self.correlated_output else emb.permute(1, 2, 0)

    def embed(self, x_new, **kwargs) -> np.ndarray:
        """The learned (scaled) embedding: (n, embedim); (b, n, embedim)
        for independent outputs, (n, embedim, b) for an ensemble."""
        x_new, _ = self.set_data(x_new)
        batch_size = kwargs.get("batch_size", len(x_new))
        emb = torch.cat([self._embed_new(x_new[i:i + batch_size])
                         for i in range(0, len(x_new), batch_size)])
        emb = emb.cpu().numpy()
        if not self.correlated_output and not self.ensemble:
            emb = emb.transpose(2, 0, 1)
        return emb
