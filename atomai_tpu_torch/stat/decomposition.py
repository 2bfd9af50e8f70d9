"""Matrix decompositions and clustering on the card (counterpart of
`atomai_tpu/stat/decomposition.py:24-335`), in place of scikit-learn.

PCA by SVD (with sklearn's sign convention), FastICA (parallel, logcosh)
on PCA-whitened data, NMF by Lee-Seung multiplicative updates, KMeans
(Lloyd, k-means++ start) and a Gaussian mixture by EM (diagonal or full
covariances), with the subset of sklearn's API the stat layer uses. Each
runs on ``device`` (the card by default; "cpu" when asked for) in float32
with TF32 off, as the GP's linear algebra does, and returns numpy. Each
algorithm starts from the JAX package's numpy ``RandomState`` draws, so
both packages start from the same state; the JAX ``fori_loop``s are
Python loops of device ops with no host sync inside (no ``.item()``, no
data-dependent shapes; the k x k symmetric decorrelation of FastICA is a
scaled Newton iteration for the polar factor, whose inverses are
``torch.linalg.inv_ex``, in float64). Pairwise (n, k, d) terms are taken
in row chunks of at most :data:`CHUNK` elements.
"""

import math
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import Precision

CHUNK = 1 << 25          # elements of an (n, k, d) block
_POLAR_ITERS = 12
_FULL = Precision.full()


def _on(X, device: torch.device) -> torch.Tensor:
    """float32 ``X`` (numpy or tensor) on ``device``."""
    if isinstance(X, torch.Tensor):
        return X.to(device, torch.float32)
    return torch.as_tensor(np.asarray(X, np.float32), device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rows(n: int, per_row: int) -> int:
    return max(1, CHUNK // max(per_row, 1))


def _svd_flip(u: torch.Tensor, v: torch.Tensor):
    """sklearn's signs: the largest-magnitude entry of each row of ``v``
    positive."""
    max_abs = torch.argmax(v.abs(), dim=1)
    signs = torch.sign(v[torch.arange(v.shape[0], device=v.device),
                         max_abs])
    return u * signs[None, :], v * signs[:, None]


class PCA:
    """Principal component analysis by SVD."""

    def __init__(self, n_components: Optional[int] = None,
                 random_state: int = 1, device: str = "cuda"):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.components_ = None
        self.mean_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None

    def _fit(self, X: torch.Tensor):
        n = X.shape[0]
        with _FULL.tf32_scope():
            mean = X.mean(0)
            u, s, vt = torch.linalg.svd(X - mean, full_matrices=False)
        u, vt = _svd_flip(u, vt)
        var = s ** 2 / max(n - 1, 1)
        k = self.n_components or min(X.shape)
        self.mean_ = _np(mean)
        self.components_ = _np(vt[:k])
        self.explained_variance_ = _np(var[:k])
        self.explained_variance_ratio_ = _np((var / var.sum())[:k])
        return u, s, k

    def fit(self, X) -> "PCA":
        self._fit(_on(X, self.device))
        return self

    def fit_transform(self, X) -> np.ndarray:
        u, s, k = self._fit(_on(X, self.device))
        return _np(u[:, :k] * s[:k][None, :])

    def transform(self, X) -> np.ndarray:
        X = _on(X, self.device)
        with _FULL.tf32_scope():
            return _np((X - _on(self.mean_, self.device))
                       @ _on(self.components_, self.device).T)


def _sym_decorrelate(W: torch.Tensor) -> torch.Tensor:
    """(W W^T)^(-1/2) W, the orthogonal polar factor of the square ``W``:
    Higham's scaled Newton iteration X <- (g X + X^-T / g) / 2 in float64,
    a fixed number of steps (no host sync)."""
    X = W.double()
    for _ in range(_POLAR_ITERS):
        inv, _ = torch.linalg.inv_ex(X)
        g = torch.sqrt(torch.linalg.matrix_norm(inv) /
                       torch.linalg.matrix_norm(X))
        X = 0.5 * (g * X + inv.T / g)
    return X.float()


class FastICA:
    """Independent component analysis (parallel FastICA, logcosh)."""

    def __init__(self, n_components: int, random_state: int = 1,
                 max_iter: int = 200, tol: float = 1e-4,
                 device: str = "cuda"):
        self.n_components = n_components
        self.random_state = random_state
        self.max_iter = max_iter
        self.tol = tol
        self.device = resolve_device(device)
        self.components_ = None
        self.mean_ = None

    def fit_transform(self, X) -> np.ndarray:
        X = _on(X, self.device)
        n = X.shape[0]
        k = self.n_components
        W0 = np.random.RandomState(self.random_state).normal(size=(k, k))
        with _FULL.tf32_scope():
            mean = X.mean(0)
            Xc = X - mean
            _, s, vt = torch.linalg.svd(Xc, full_matrices=False)
            K = vt[:k] / s[:k][:, None] * math.sqrt(n)      # (k, d)
            Xw = Xc @ K.T                                   # (n, k)
            W = _sym_decorrelate(_on(W0, self.device))
            for _ in range(self.max_iter):
                g = torch.tanh(Xw @ W.T)
                W = _sym_decorrelate(
                    g.T @ Xw / n - (1.0 - g ** 2).mean(0)[:, None] * W)
            sources = Xw @ W.T
            components = W @ K
        self.mean_ = _np(mean)
        self._unmixing = _np(W)
        self.components_ = _np(components)
        return _np(sources)

    def transform(self, X) -> np.ndarray:
        X = _on(X, self.device)
        with _FULL.tf32_scope():
            return _np((X - _on(self.mean_, self.device))
                       @ _on(self.components_, self.device).T)


class NMF:
    """Non-negative matrix factorisation (multiplicative updates)."""

    def __init__(self, n_components: int, random_state: int = 1,
                 max_iter: int = 1000, tol: float = 1e-5,
                 device: str = "cuda"):
        self.n_components = n_components
        self.random_state = random_state
        self.max_iter = max_iter
        self.device = resolve_device(device)
        self.components_ = None

    def fit_transform(self, X) -> np.ndarray:
        if isinstance(X, torch.Tensor):
            X = _on(X, self.device).clamp_min(0.0)
            mean = float(X.mean())
        else:
            Xn = np.maximum(np.asarray(X, np.float32), 0.0)
            mean = float(Xn.mean())
            X = _on(Xn, self.device)
        n, d = X.shape
        k = self.n_components
        rng = np.random.RandomState(self.random_state)
        scale = float(np.sqrt(mean / k + 1e-12))
        W = _on(np.abs(rng.normal(size=(n, k))) * scale, self.device)
        H = _on(np.abs(rng.normal(size=(k, d))) * scale, self.device)
        eps = 1e-10
        with _FULL.tf32_scope():
            for _ in range(self.max_iter):
                H = H * (W.T @ X) / (W.T @ W @ H + eps)
                W = W * (X @ H.T) / (W @ (H @ H.T) + eps)
        self.components_ = _np(H)
        return _np(W)

    def transform(self, X) -> np.ndarray:
        """Projection onto the fitted H by 200 multiplicative updates of
        W from a fresh draw."""
        X = _on(X, self.device).clamp_min(0.0)
        H = _on(self.components_, self.device)
        n, k = X.shape[0], H.shape[0]
        rng = np.random.RandomState(self.random_state)
        W = _on(np.abs(rng.normal(size=(n, k))), self.device)
        with _FULL.tf32_scope():
            for _ in range(200):
                W = W * (X @ H.T) / (W @ (H @ H.T) + 1e-10)
        return _np(W)


def _sq_dist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, as sum((x - c)^2), in row chunks."""
    step = _rows(X.shape[0], C.numel())
    return torch.cat([((X[i:i + step, None, :] - C[None]) ** 2).sum(-1)
                      for i in range(0, X.shape[0], step)])


class KMeans:
    """Lloyd's k-means from a k-means++ start."""

    def __init__(self, n_clusters: int, random_state: int = 42,
                 max_iter: int = 100, device: str = "cuda"):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.max_iter = max_iter
        self.device = resolve_device(device)
        self.cluster_centers_ = None

    def _init_centers(self, X: torch.Tensor) -> torch.Tensor:
        """k-means++ with the JAX package's draws: the distances on the
        device, each centre's choice on the host."""
        rng = np.random.RandomState(self.random_state)
        n = X.shape[0]
        idx = [rng.randint(n)]
        d2 = None
        for _ in range(1, self.n_clusters):
            new = ((X - X[idx[-1]]) ** 2).sum(1)
            d2 = new if d2 is None else torch.minimum(d2, new)
            p = d2.double().cpu().numpy()
            if p.sum() <= 0:
                idx.append(rng.randint(n))
                continue
            p = p / p.sum()
            idx.append(rng.choice(n, p=p / p.sum()))
        return X[idx].clone()

    def fit(self, X) -> "KMeans":
        X = _on(X, self.device)
        k = self.n_clusters
        arange = torch.arange(k, device=self.device)
        with _FULL.tf32_scope():
            centers = self._init_centers(X)
            for _ in range(self.max_iter):
                onehot = (_sq_dist(X, centers).argmin(1)[:, None]
                          == arange).float()
                counts = onehot.sum(0)
                new = onehot.T @ X / counts.clamp_min(1.0)[:, None]
                centers = torch.where(counts[:, None] > 0, new, centers)
        self.cluster_centers_ = _np(centers)
        self.labels_ = self._predict(X)
        return self

    def _predict(self, X: torch.Tensor) -> np.ndarray:
        C = _on(self.cluster_centers_, self.device)
        with _FULL.tf32_scope():
            return _np(_sq_dist(X, C).argmin(1))

    def predict(self, X) -> np.ndarray:
        return self._predict(_on(X, self.device))

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_


_LOG_2PI = math.log(2 * math.pi)


class GaussianMixture:
    """Gaussian mixture by EM, diagonal or full covariances ("tied" runs as
    "full" and "spherical" as "diag", as in the JAX package), from a
    KMeans start; ``reg_covar`` is added to every variance."""

    def __init__(self, n_components: int, covariance_type: str = "diag",
                 random_state: int = 1, max_iter: int = 100,
                 reg_covar: float = 1e-6, device: str = "cuda"):
        if covariance_type not in ("diag", "full", "spherical", "tied"):
            raise ValueError("Unknown covariance type")
        self.n_components = n_components
        self.covariance_type = {"tied": "full", "spherical": "diag"}.get(
            covariance_type, covariance_type)
        self.random_state = random_state
        self.max_iter = max_iter
        self.reg_covar = reg_covar
        self.device = resolve_device(device)
        self.means_ = None
        self.weights_ = None
        self.covariances_ = None

    def _log_prob(self, X: torch.Tensor, means: torch.Tensor,
                  covs: torch.Tensor) -> torch.Tensor:
        """(n, k) log densities of each point under each component."""
        d = X.shape[1]
        if self.covariance_type == "diag":
            prec = 1.0 / covs
            step = _rows(X.shape[0], means.numel())
            maha = torch.cat([
                ((X[i:i + step, None, :] - means[None]) ** 2
                 * prec[None]).sum(-1)
                for i in range(0, X.shape[0], step)])
            return -0.5 * (maha + torch.log(covs).sum(-1)[None]
                           + d * _LOG_2PI)
        L, _ = torch.linalg.cholesky_ex(covs)                 # (k, d, d)
        diff = (X[None] - means[:, None]).transpose(1, 2)      # (k, d, n)
        sol = torch.linalg.solve_triangular(L, diff, upper=False)
        maha = (sol ** 2).sum(1)                               # (k, n)
        logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return (-0.5 * (maha + logdet[:, None] + d * _LOG_2PI)).T

    def _m_step_covs(self, X, resp, means, nk):
        k, d = means.shape
        if self.covariance_type == "diag":
            step = _rows(X.shape[0], means.numel())
            acc = torch.zeros_like(means)
            for i in range(0, X.shape[0], step):
                diff2 = (X[i:i + step, None, :] - means[None]) ** 2
                acc += torch.einsum("nk,nkd->kd", resp[i:i + step], diff2)
            return acc / nk[:, None] + self.reg_covar
        diff = X[None] - means[:, None]                        # (k, n, d)
        covs = torch.einsum("kn,knd,kne->kde", resp.T, diff, diff)
        return covs / nk[:, None, None] + \
            self.reg_covar * torch.eye(d, device=X.device)[None]

    def fit_predict(self, X) -> np.ndarray:
        X = _on(X, self.device)
        n, d = X.shape
        k = self.n_components
        km = KMeans(k, random_state=self.random_state, device=self.device)
        km.fit(X)
        reg = self.reg_covar
        with _FULL.tf32_scope():
            means = _on(km.cluster_centers_, self.device)
            if self.covariance_type == "diag":
                covs = torch.ones(k, d, device=self.device) * \
                    X.var(0, unbiased=False)[None] + reg
            else:
                base = torch.cov(X.T).reshape(d, d) + \
                    reg * torch.eye(d, device=self.device)
                covs = base.expand(k, d, d).clone()
            weights = torch.full((k,), 1.0 / k, device=self.device)
            for _ in range(self.max_iter):
                lp = self._log_prob(X, means, covs) + torch.log(weights)[None]
                resp = torch.exp(lp - torch.logsumexp(lp, 1, keepdim=True))
                nk = resp.sum(0) + 1e-10
                means = resp.T @ X / nk[:, None]
                covs = self._m_step_covs(X, resp, means, nk)
                weights = nk / nk.sum()
            lp = self._log_prob(X, means, covs) + torch.log(weights)[None]
        self.means_ = _np(means)
        self.covariances_ = _np(covs)
        self.weights_ = _np(weights)
        return _np(lp.argmax(1))

    def fit(self, X) -> "GaussianMixture":
        self.fit_predict(X)
        return self

    def _weighted_log_prob(self, X) -> torch.Tensor:
        X = _on(X, self.device)
        with _FULL.tf32_scope():
            return self._log_prob(
                X, _on(self.means_, self.device),
                _on(self.covariances_, self.device)) + \
                torch.log(_on(self.weights_, self.device))[None]

    def predict(self, X) -> np.ndarray:
        return _np(self._weighted_log_prob(X).argmax(1))

    def predict_proba(self, X) -> np.ndarray:
        """Each component's responsibility for each point."""
        lp = self._weighted_log_prob(X)
        return _np(torch.softmax(lp, 1))
