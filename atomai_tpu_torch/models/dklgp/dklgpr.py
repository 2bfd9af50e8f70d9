"""dklGPR: deep-kernel-learning GP regression.

Counterpart of `atomai_tpu/models/dklgp/dklgpr.py`: ``fit``,
``fit_ensemble`` (a replicated scalar target -> independent GPs), the
posterior with the training-side Cholesky factorised once per fit,
``sample_from_posterior``, Thompson sampling, batched ``predict`` and
``embed``. The posterior draws take their noise from the model's
generator stream, or from ``eps`` when the caller passes it.
"""

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...trainers.gptrainer import (_FULL, _cholesky, dklGPTrainer,
                                   posterior_cache, posterior_from_cache)


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
    def _get_cache(self):
        """(cache, training embedding): the factorisation of every output,
        computed once per fit."""
        if self._post_cache is None:
            z = self._embed(self.X, self.scale_stats)
            with _FULL.tf32_scope():
                cache = posterior_cache(self.gp_params, z, self.y,
                                        self.kernel)
            self._post_cache = (cache, z)
        return self._post_cache

    @torch.no_grad()
    def _posteriors(self, Xs: torch.Tensor, full_cov: bool = False):
        """Each output's posterior at Xs: mean (b, M) and variance (b, M)
        or covariance (b, M, M)."""
        cache, z_train = self._get_cache()
        z_s = self._embed(Xs, self.scale_stats)
        with _FULL.tf32_scope():
            return posterior_from_cache(cache, z_train, z_s, self.kernel,
                                        full_cov=full_cov)

    @torch.no_grad()
    def sample_from_posterior(self, X, num_samples: int = 1000,
                              eps: Optional[torch.Tensor] = None
                              ) -> np.ndarray:
        """(num_samples, b, M) draws from the posterior at X. ``eps``: the
        (num_samples, b, M) standard normal noise; drawn from the model's
        generator stream when None."""
        Xs, _ = self.set_data(X)
        mean, cov = self._posteriors(Xs, full_cov=True)
        b, M = mean.shape
        if eps is None:
            eps = torch.randn((num_samples, b, M), device=self.device,
                              generator=self.keys.next(device=self.device))
        eps = torch.as_tensor(eps, dtype=mean.dtype, device=self.device)
        with _FULL.tf32_scope():
            L = _cholesky(cov + 1e-6 * torch.eye(M, device=self.device))
            samples = mean[None] + torch.einsum("bmn,sbn->sbm", L, eps)
        return samples.cpu().numpy()

    def thompson(self, X_cand, scalarize_func: Optional[Callable] = None,
                 maximize: bool = True, eps: Optional[torch.Tensor] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Thompson sampling for the next measurement point: one posterior
        draw (``eps`` (1, b, M) as in :meth:`sample_from_posterior`) and its
        argmax (argmin); ``scalarize_func`` maps a multi-output draw
        (b, M) to one row."""
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
