"""Gaussian-process trainers: exact GP and deep kernel learning.

Counterpart of `atomai_tpu/trainers/gptrainer.py`. The GP is dense linear
algebra, as in the JAX package: the Cholesky factor of the ARD kernel
matrix, triangular solves for the marginal log-likelihood (MLL) and the
posterior. 'sparse' and 'kissgp' are the SGPR collapsed bound (Titsias
2009) with free or regular-grid inducing points (`:100-170`).

Where the JAX package vmaps over outputs, these functions take a leading
output axis: a parameter dict whose ``raw_lengthscale`` is (b, d) gives
(b,)-shaped losses and (b, ...) posteriors; one whose ``raw_lengthscale``
is (d,) gives what the JAX function gives. Inputs ``X`` are (N, d),
shared by the outputs, or (b, N, d). The constants are the JAX package's,
bit for bit: ``JITTER``, the noise floor 1e-4 (and SGPR's second 1e-4),
the Kmm jitter ``JITTER + 1e-4 * outputscale``, the variance floor 1e-10;
the MLL is mean-reduced by N and the losses of several outputs summed.

The factorisations use ``torch.linalg.cholesky_ex``: no host sync, and a
factor that failed is set to NaN (what ``jnp.linalg.cholesky`` returns),
so the loss goes NaN where the JAX package's does. The exact MLL's factor,
solve and gradient of a float32 K on a card, N up to
``spd_mll.MLL_KERNEL_MAX_N``, are instead the kernel pair of
``ops/spd_mll.py`` (a closed-form gradient, NaN where the factor fails);
a chunk of steps counts its route, ``gp.mll_kernel`` or
``gp.mll_library``, replayed steps too. The trainers run the
kernel matrices, factorisations and solves with TF32 off, forward and
backward; the feature extractor runs in float32 under the policy's TF32
switch (a two-stage backward: the GP part to the embedding, then the
extractor). Losses are fetched once per ``print_loss`` chunk.

On one card, a run's step is captured in a CUDA graph (``core/graphs.py``)
after its first ``GRAPH_WARMUP`` steps and replayed for the rest of the
run: one launch a step instead of some 550, so that a fit of a few
hundred points is no longer bound by the host's launches. Adam keeps its
state on the card (``capturable``) from the first step, so eager and
replayed steps are the same arithmetic, bit for bit.

The DKL trainers record the spans (``core.profiling``) ``dkl.fit`` around
``run``, ``dkl.fit.fetch`` around each chunk's loss fetch and
``dkl.upload`` around ``set_data``'s copies.

Independent outputs over the model axis (`:488-527`): in a world of
several ranks, ``compile_multi_model_trainer(mesh=None)`` spreads the b
(extractor, GP) pairs over an ``ensemble_mesh`` (``mesh=False``: every
rank trains all of them; a ``DeviceMesh`` is used as given; where no
mesh spreads them, every rank trains all of them and takes rank 0's at
the end). Every rank
holds all b pairs, drawn as one process draws them, and trains its
contiguous block: the forward runs its block's extractors, the gradient
is that of the summed loss over all b outputs (the block's own part of
it), and the reported loss is that sum, all-reduced. After a run every
block is broadcast from its owner, so each rank predicts with every
pair. The shared-embedding ``compile_trainer`` and the exact
``GPTrainer`` take ``mesh`` and ignore it, as the JAX package's do. The
JAX package's ``engine`` attribute (scan or loop) has no counterpart: the
port has one loop, its step replayed from a CUDA graph on one card.
"""

import contextlib
import copy
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import graphs, profiling
from ..core.checkpoint import is_jax_tree, load_checkpoint, save_checkpoint
from ..core.device import resolve_device
from ..core.dtypes import Precision, default_precision
from ..core.mesh import (MODEL_AXIS, all_sum, axis_size, block, block_owner,
                         broadcast_tensors, resolve_model_mesh,
                         sync_from_rank0)
from ..core.prng import GeneratorSeq
from ..nets.blocks import init_weights_
from ..nets.gp import (KERNELS, MemberStack, StackedFeatureExtractor,
                       _as_tensor, compute_bounds_stats, constrain,
                       fcFeatureExtractor, init_gp_params, kernel_diag,
                       scale_to_bounds, softplus)
from ..ops import spd_mll

JITTER = 1e-5
# eager steps of a run on a card before its step is captured
GRAPH_WARMUP = 3
_FULL = Precision.full()
_LOG_2PI = math.log(2 * math.pi)


def _hyp(params, lengthscale_constraints=None):
    """Raw -> constrained hyperparameters."""
    raw_ls = params["raw_lengthscale"]
    if lengthscale_constraints is not None:
        lo = torch.as_tensor(lengthscale_constraints[0], dtype=raw_ls.dtype,
                             device=raw_ls.device)
        hi = torch.as_tensor(lengthscale_constraints[1], dtype=raw_ls.dtype,
                             device=raw_ls.device)
        ls = constrain(raw_ls, lo, hi)
    else:
        ls = softplus(raw_ls)
    os_ = softplus(params["raw_outputscale"])
    noise = softplus(params["raw_noise"]) + 1e-4
    return ls, os_, noise, params["mean_const"]


def _batched_hyp(params, lengthscale_constraints):
    """(single, ls (b, d), os (b,), noise (b,), mean (b,)); ``single`` when
    the parameters had no output axis (then b = 1)."""
    ls, os_, noise, mean = _hyp(params, lengthscale_constraints)
    single = ls.ndim == 1
    if single:
        ls, os_, noise, mean = ls[None], os_[None], noise[None], mean[None]
    return single, ls, os_, noise, mean


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorisation failed."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None],
                       L.new_full((), float("nan")), L)


def _add_diag(K: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K + diag(d) for (b, n, n) K and (b,) d."""
    return K + torch.diag_embed(d[:, None].expand(-1, K.shape[-1]))


def _tri(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-1 B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def _cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 r for (b, n) r."""
    v = _tri(L, r[..., None])
    return torch.linalg.solve_triangular(L.mT, v, upper=True)[..., 0]


def _exact_factor(X, ls, os_, noise, kernel):
    K = kernel(X, X, ls, os_)
    return _cholesky(_add_diag(K, noise + JITTER))


def _mll_terms(K: torch.Tensor, r: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r^T K^-1 r, log det K / 2), each (b,), by the route
    ``spd_mll.route`` picks: the kernel pair, or the library's factor and
    solve under autograd."""
    if spd_mll.route(K.device, K.dtype, K.shape[-1]) == "kernel":
        return spd_mll.mll_terms(K, r)
    L = _cholesky(K)
    # r^T K^-1 r = |L^-1 r|^2: one solve, whose backward is an outer
    # product (cho_solve's would be an N^3 product)
    v = _tri(L, r[..., None])[..., 0]
    return (torch.sum(v * v, dim=-1),
            torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1))


def neg_mll(params, X, y, kernel: Callable, lengthscale_constraints=None):
    """Exact-GP negative MLL, mean-reduced by N. X: (N, d) or (b, N, d),
    y: (N,) or (b, N)."""
    single, ls, os_, noise, mean = _batched_hyp(params,
                                                lengthscale_constraints)
    K = _add_diag(kernel(X, X, ls, os_), noise + JITTER)
    N = K.shape[-1]
    q, h = _mll_terms(K, y - mean[:, None])
    mll = -0.5 * q - h - 0.5 * N * _LOG_2PI
    out = -mll / N
    return out[0] if single else out


def posterior_cache(params, X, y, kernel: Callable,
                    lengthscale_constraints=None) -> dict:
    """The training-side factorisation (L, alpha), so that repeated
    posterior evaluations skip the O(N^3) Cholesky. Without an output
    axis the cache is the JAX package's (``ls`` (1, d), ``os`` (1,));
    with one, every entry has it (``ls`` (b, d), ``os`` (b,))."""
    single, ls, os_, noise, mean = _batched_hyp(params,
                                                lengthscale_constraints)
    L = _exact_factor(X, ls, os_, noise, kernel)
    alpha = _cho_solve(L, y - mean[:, None])
    if single:
        return {"L": L[0], "alpha": alpha[0], "mean": mean[0], "ls": ls,
                "os": os_}
    return {"L": L, "alpha": alpha, "mean": mean, "ls": ls, "os": os_}


def _exact_posterior(L, alpha, mean, ls, os_, X, Xs, kernel, full_cov):
    Ks = kernel(X, Xs, ls, os_)                          # (b, N, M)
    mean_s = mean[:, None] + (Ks.mT @ alpha[..., None])[..., 0]
    v = _tri(L, Ks)
    if full_cov:
        return mean_s, kernel(Xs, Xs, ls, os_) - v.mT @ v
    kss = kernel_diag(kernel, Xs, ls, os_)
    return mean_s, torch.clamp_min(kss - torch.sum(v * v, dim=-2), 1e-10)


def posterior_from_cache(cache, X, Xs, kernel: Callable,
                         full_cov: bool = False):
    """Posterior (mean, var or cov) at Xs from :func:`posterior_cache`."""
    if cache["L"].ndim == 2:
        m, v = _exact_posterior(cache["L"][None], cache["alpha"][None],
                                cache["mean"][None], cache["ls"],
                                cache["os"], X, Xs, kernel, full_cov)
        return m[0], v[0]
    return _exact_posterior(cache["L"], cache["alpha"], cache["mean"],
                            cache["ls"], cache["os"], X, Xs, kernel,
                            full_cov)


def _sgpr_factors(X, y, Z, ls, os_, sigma2, mean, kernel):
    m = Z.shape[-2]
    L = _cholesky(_add_diag(kernel(Z, Z, ls, os_), JITTER + 1e-4 * os_))
    sd = torch.sqrt(sigma2)
    A = _tri(L, kernel(Z, X, ls, os_)) / sd[:, None, None]       # (b, m, n)
    LB = _cholesky(torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.mT)
    resid = (y - mean[:, None]) / sd[:, None]
    c = _tri(LB, A @ resid[..., None])[..., 0]
    return L, A, LB, resid, c


def neg_mll_sparse(params, X, y, Z, kernel: Callable,
                   lengthscale_constraints=None):
    """SGPR collapsed bound, negated and mean-reduced by n. Z (m, d) are
    the inducing inputs ('sparse', and 'kissgp' on a regular grid)."""
    single, ls, os_, noise, mean = _batched_hyp(params,
                                                lengthscale_constraints)
    n = X.shape[-2]
    sigma2 = noise + 1e-4
    _, A, LB, resid, c = _sgpr_factors(X, y, Z, ls, os_, sigma2, mean,
                                       kernel)
    knn = kernel_diag(kernel, X, ls, os_)
    qnn = sigma2[:, None] * torch.sum(A * A, dim=-2)
    bound = (-0.5 * n * torch.log(2 * math.pi * sigma2)
             - torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), -1)
             - 0.5 * torch.sum(resid * resid, -1)
             + 0.5 * torch.sum(c * c, -1)
             - 0.5 / sigma2 * (torch.sum(knn, -1) - torch.sum(qnn, -1)))
    out = -bound / n
    return out[0] if single else out


def sparse_posterior_cache(params, X, y, Z, kernel: Callable,
                           lengthscale_constraints=None) -> dict:
    """The SGPR posterior's precomputed factors (output axis as in
    :func:`posterior_cache`)."""
    single, ls, os_, noise, mean = _batched_hyp(params,
                                                lengthscale_constraints)
    L, _, LB, _, c = _sgpr_factors(X, y, Z, ls, os_, noise + 1e-4, mean,
                                   kernel)
    if single:
        L, LB, c, mean = L[0], LB[0], c[0], mean[0]
    return {"L": L, "LB": LB, "c": c, "mean": mean, "ls": ls, "os": os_,
            "Z": Z}


def sparse_posterior(cache, Xs, kernel: Callable):
    """SGPR predictive mean and variance at Xs."""
    single = cache["L"].ndim == 2
    L, LB, c, mean = (cache[k] for k in ("L", "LB", "c", "mean"))
    if single:
        L, LB, c, mean = L[None], LB[None], c[None], mean[None]
    Kms = kernel(cache["Z"], Xs, cache["ls"], cache["os"])       # (b, m, s)
    tmp1 = _tri(L, Kms)
    tmp2 = _tri(LB, tmp1)
    mean_s = mean[:, None] + (tmp2.mT @ c[..., None])[..., 0]
    kss = kernel_diag(kernel, Xs, cache["ls"], cache["os"])
    var_s = torch.clamp_min(kss - torch.sum(tmp1 * tmp1, dim=-2)
                            + torch.sum(tmp2 * tmp2, dim=-2), 1e-10)
    return (mean_s[0], var_s[0]) if single else (mean_s, var_s)


def make_inducing_grid(X, grid_points_ratio: float = 1.0,
                       max_points: int = 1024) -> torch.Tensor:
    """Regular inducing grid over the inputs' bounding box, never more
    points than training points (the JAX package's numpy arithmetic, so
    both give the same grid); float32 on X's device."""
    device = X.device if isinstance(X, torch.Tensor) else "cpu"
    X = X.detach().cpu().numpy() if isinstance(X, torch.Tensor) \
        else np.asarray(X)
    d = X.shape[-1]
    budget = min(max_points * grid_points_ratio, X.shape[0])
    per_dim = max(2, int(round(budget ** (1.0 / d))))
    axes = [np.linspace(X[:, i].min(), X[:, i].max(), per_dim)
            for i in range(d)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
    return torch.as_tensor(grid, dtype=torch.float32, device=device)


def posterior(params, X, y, Xs, kernel: Callable,
              lengthscale_constraints=None, full_cov: bool = False):
    """Latent-function posterior at Xs given the training data (X, y)."""
    cache = posterior_cache(params, X, y, kernel, lengthscale_constraints)
    return posterior_from_cache(cache, X, Xs, kernel, full_cov)


class GPTrainer:
    """Exact (or SGPR) GP regression trainer (counterpart of
    `atomai_tpu/trainers/gptrainer.py:215-406`).

    Keyword args: ``seed`` (0), ``device`` ("cuda", the default, raises
    without a card; or "cpu"). ``precision`` ("single") is accepted as the
    JAX package accepts it: the GP computes in ``dtype``, float32 (the
    ``Reconstructor``'s float64). Nothing seeds a
    global generator; the 'sparse' inducing draw uses its own
    ``RandomState(seed)``, as in the JAX package.
    """

    # the dtype of the data, the GP parameters and the linear algebra
    dtype = torch.float32
    # the prefix of the trainer's spans; None: no spans
    SPANS: Optional[str] = None

    def __init__(self, **kwargs):
        self.device = resolve_device(kwargs.get("device", "cuda"))
        self.seed = kwargs.get("seed", 0)
        self.keys = GeneratorSeq(self.seed)
        self.precision = default_precision(self.device)
        self.gp_params = None
        self.compiled = False
        self.train_loss: List[float] = []
        self.X = self.y = None
        self.kernel = KERNELS["rbf"]
        self.lengthscale_constraints = None
        self.kernel_type = "exact"
        self.inducing_points = None
        self.training_cycles = 1
        self.lr = None
        self.optimizer = None
        self._graph: Optional[graphs.GraphedCall] = None
        self._post_cache = None
        # the outputs' mesh (multi-output DKL) and this rank's block of
        # the outputs (None: all of them)
        self.model_mesh = None
        self._mesh_pref = None
        self._block: Optional[slice] = None

    def set_data(self, x, y=None, device=None):
        """Tensors of the trainer's dtype on its device; a 1D y becomes
        (1, N)."""
        with self._span("upload"):
            x = _as_tensor(x, self.device, self.dtype)
            if y is not None:
                y = _as_tensor(y, self.device, self.dtype)
                if y.ndim == 1:
                    y = y[None]
        return x, y

    def _trainable(self) -> list:
        return list(self.gp_params.values())

    def _span(self, name: str):
        return contextlib.nullcontext() if self.SPANS is None else \
            profiling.span(f"{self.SPANS}.{name}")

    def _graphed(self) -> bool:
        """Whether the fit's step is captured: on one card."""
        return self.device.type == "cuda" and self.model_mesh is None

    def _reset_optimizer(self) -> None:
        """Adam as ``optax.adam`` (eps outside the sqrt, bias-corrected),
        its state on the card there."""
        self.optimizer = torch.optim.Adam(
            self._trainable(), lr=self.lr,
            capturable=self.device.type == "cuda")

    def compile_trainer(self, X, y, training_cycles: int = 1, **kwargs):
        """``kernel_type``: 'exact' (default), 'sparse' (SGPR on
        ``inducing_points``, or ``num_inducing`` (512) training points drawn
        with ``RandomState(seed)``) or 'kissgp' (SGPR on a regular grid
        sized by ``grid_points_ratio``). ``base_kernel``: 'rbf', 'matern'
        or a callable; ``lengthscale_constraints``: [lower, upper];
        ``lr`` (0.1). ``mesh`` is taken and not used (one GP)."""
        self.X, self.y = self.set_data(X, y)
        base_kernel = kwargs.get("base_kernel", "rbf")
        self.kernel = KERNELS[base_kernel] if isinstance(base_kernel, str) \
            else base_kernel
        lc = kwargs.get("lengthscale_constraints")
        self.lengthscale_constraints = None if lc is None else tuple(
            _as_tensor(v, self.device, self.dtype) for v in lc)
        self.kernel_type = kwargs.get("kernel_type", "exact")
        self.inducing_points = None
        if self.kernel_type == "sparse":
            Z = kwargs.get("inducing_points")
            if Z is None:
                m = min(kwargs.get("num_inducing", 512), self.X.shape[0])
                idx = np.random.RandomState(self.seed).choice(
                    self.X.shape[0], m, replace=False)
                Z = self.X[torch.as_tensor(idx, device=self.device)]
            self.inducing_points = _as_tensor(Z, self.device, self.dtype)
        elif self.kernel_type == "kissgp":
            self.inducing_points = make_inducing_grid(
                self.X, kwargs.get("grid_points_ratio", 1.0)).to(self.dtype)
        elif self.kernel_type != "exact":
            raise ValueError(
                "kernel_type must be 'exact', 'sparse' or 'kissgp'")
        b = self.y.shape[0]
        self.gp_params = {k: v.to(self.dtype).requires_grad_() for k, v in
                          init_gp_params(self.X.shape[-1],
                                         (b,) if b > 1 else (),
                                         self.device).items()}
        self.lr = kwargs.get("lr", 0.1)
        self._reset_optimizer()
        self.training_cycles = training_cycles
        self.compiled = True
        # a factorisation of a previous fit would be served against the
        # new X and y
        self._post_cache = None

    def _targets(self, gp) -> torch.Tensor:
        """y without its output axis for parameters without one."""
        return self.y[0] if gp["raw_lengthscale"].ndim == 1 else self.y

    def _gp_loss(self, gp, X, y=None) -> torch.Tensor:
        """The summed negative MLL (or SGPR bound) of ``gp`` at inputs X
        (targets ``y``, by default the trainer's)."""
        y = self._targets(gp) if y is None else y
        if self.inducing_points is not None:
            losses = neg_mll_sparse(gp, X, y, self.inducing_points,
                                    self.kernel, self.lengthscale_constraints)
        else:
            losses = neg_mll(gp, X, y, self.kernel,
                             self.lengthscale_constraints)
        return torch.sum(losses)

    def _loss_fn(self) -> torch.Tensor:
        """The training loss at the current parameters."""
        return self._gp_loss(self.gp_params, self.X)

    def _loss_backward(self) -> torch.Tensor:
        with _FULL.tf32_scope():
            loss = self._loss_fn()
            loss.backward()
        return loss

    def _step(self) -> torch.Tensor:
        """One Adam step; the loss summed over every rank's block of the
        outputs."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_backward()
        self.optimizer.step()
        return all_sum(loss.detach(), self.model_mesh, MODEL_AXIS)

    def _mll_route(self) -> Optional[str]:
        """The route of the exact MLL's factor, solve and gradient in this
        trainer's steps (``spd_mll.route``); None for SGPR."""
        if self.inducing_points is not None:
            return None
        return spd_mll.route(self.device, self.dtype, self.X.shape[-2])

    def _run_chunk(self, n: int) -> None:
        route = self._mll_route()
        if route is not None:
            # here, not in the step: a replayed step runs no Python
            profiling.count(f"gp.mll_{route}", n)
        if self._graph is None:
            losses = [self._step() for _ in range(n)]
        else:
            with graphs.capture_stream(self.device):
                losses = [self._graph(self._step) for _ in range(n)]
        with self._span("fit.fetch"):
            self.train_loss.extend(torch.stack(losses).tolist())  # one fetch

    def train_step(self) -> None:
        """One optimisation step."""
        self._run_chunk(1)
        self._post_cache = None

    def run(self, X=None, y=None, training_cycles: int = 1, **kwargs):
        """Trains for the compiled number of cycles (compiling first with
        these arguments if needed), printing every ``print_loss`` (10)."""
        with self._span("fit"):
            return self._run(X, y, training_cycles, **kwargs)

    def _run(self, X=None, y=None, training_cycles: int = 1, **kwargs):
        if not self.compiled:
            self.compile_trainer(X, y, training_cycles, **kwargs)
        print_loss = kwargs.get("print_loss", 10)
        # captured anew every run, so it shares the card's last pool: a run
        # reuses the blocks of the runs before
        self._graph = graphs.GraphedCall(GRAPH_WARMUP, private=False) \
            if self._graphed() else None
        try:
            e = 0
            while e < self.training_cycles:
                n = min(print_loss, self.training_cycles - e)
                self._run_chunk(n)
                e += n
                self.print_statistics(e - 1)
        finally:
            self._graph = None
        self._post_cache = None
        return self

    def print_statistics(self, e: int) -> None:
        print("Epoch {}/{} ...".format(e + 1, self.training_cycles),
              "Training loss: {}".format(
                  np.around(self.train_loss[-1], 4)))

    @torch.no_grad()
    def predict(self, Xs, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance at new points; the training-side
        factorisation is computed once per fit."""
        Xs, _ = self.set_data(Xs)
        gp = self.gp_params
        y = self._targets(gp)
        with _FULL.tf32_scope():
            if self._post_cache is None:
                if self.inducing_points is not None:
                    self._post_cache = sparse_posterior_cache(
                        gp, self.X, y, self.inducing_points, self.kernel,
                        self.lengthscale_constraints)
                else:
                    self._post_cache = posterior_cache(
                        gp, self.X, y, self.kernel,
                        self.lengthscale_constraints)
            if self.inducing_points is not None:
                m, v = sparse_posterior(self._post_cache, Xs, self.kernel)
            else:
                m, v = posterior_from_cache(self._post_cache, self.X, Xs,
                                            self.kernel)
        return m.float().cpu().numpy(), v.float().cpu().numpy()


class dklGPTrainer(GPTrainer):
    """Deep-kernel-learning GP trainer (counterpart of
    `atomai_tpu/trainers/gptrainer.py:409-610`): a feature extractor ->
    ScaleToBounds -> an ARD-RBF GP per output. Shared embedding
    (:meth:`compile_trainer`) or one extractor and GP per output
    (:meth:`compile_multi_model_trainer`, a :class:`StackedFeatureExtractor`
    whose copies start equal unless ``ensemble``). ``lr`` defaults to
    0.01."""

    SPANS = "dkl"

    def __init__(self, indim: int, embedim: int = 2,
                 shared_embedding_space: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.dimdict = {"input_dim": indim, "embedim": embedim}
        self.correlated_output = shared_embedding_space
        self.ensemble = False
        self.fe: Optional[torch.nn.Module] = None
        self.freeze_weights = False
        # the training embedding's min/max, set after each run(): test and
        # candidate points share the training transform
        self.scale_stats = None

    def _init_fe(self, feature_net=None, n_copies: int = 1,
                 identical: bool = True) -> torch.nn.Module:
        indim, embedim = self.dimdict["input_dim"], self.dimdict["embedim"]

        def make(g):
            net = fcFeatureExtractor(indim, embedim) if feature_net is None \
                else feature_net(indim, embedim)
            init_weights_(net, g)
            return net

        if n_copies == 1:
            return make(self.keys.next()).to(self.device)
        if identical:
            first = make(self.keys.next())
            members = [copy.deepcopy(first) for _ in range(n_copies)]
        else:
            members = [make(g) for g in self.keys.next(n_copies)]
        if isinstance(members[0], fcFeatureExtractor):
            return StackedFeatureExtractor.from_members(members).to(
                self.device)
        return MemberStack(members).to(self.device)

    def _embed(self, X, stats=None) -> torch.Tensor:
        with self.precision.tf32_scope():
            z = self.fe(X)
        return scale_to_bounds(z, stats=stats)

    @torch.no_grad()
    def _compute_scale_stats(self) -> None:
        """Stores the training embedding's min/max ((1, e), or (b, 1, e)
        per output), so that eval-time embeddings of any batch size share
        the training transform."""
        with self.precision.tf32_scope():
            self.scale_stats = compute_bounds_stats(self.fe(self.X))

    def _compile(self, X, y, training_cycles, n_copies, identical, kwargs):
        self.X, self.y = self.set_data(X, y)
        self._mesh_pref = kwargs.get("mesh")
        self.model_mesh = resolve_model_mesh(self._mesh_pref, n_copies) \
            if n_copies > 1 else None
        self._block = None if self.model_mesh is None else \
            block(n_copies, self.model_mesh, MODEL_AXIS)
        self.fe = self._init_fe(kwargs.get("feature_extractor"), n_copies,
                                identical)
        self.freeze_weights = kwargs.get("freeze_weights", False)
        self.gp_params = {k: v.requires_grad_() for k, v in init_gp_params(
            self.dimdict["embedim"], (self.y.shape[0],),
            self.device).items()}
        self.lr = kwargs.get("lr", 0.01)
        self._reset_optimizer()
        self.training_cycles = training_cycles
        self.compiled = True
        self.scale_stats = None
        self._post_cache = None

    def _graphed(self) -> bool:
        """On one card, with the package's own extractor (one given by the
        caller may do what a capture cannot)."""
        return super()._graphed() and isinstance(
            self.fe, (fcFeatureExtractor, StackedFeatureExtractor))

    def _trainable(self) -> list:
        params = list(self.gp_params.values())
        return params if self.freeze_weights else \
            params + list(self.fe.parameters())

    def compile_trainer(self, X, y, training_cycles: int = 1, **kwargs):
        """Shared-embedding DKL. kwargs: ``feature_extractor`` (an
        ``nn.Module`` class taking (indim, embedim)), ``freeze_weights``,
        ``lr`` (0.01); ``mesh`` is taken and not used."""
        if not self.correlated_output:
            raise NotImplementedError(
                "To compile a DKL-GP trainer for independent outputs "
                "use compile_multi_model_trainer(*args, **kwargs)")
        self._compile(X, y, training_cycles, 1, True, kwargs)

    def compile_multi_model_trainer(self, X, y, training_cycles: int = 1,
                                    **kwargs):
        """Independent outputs: one extractor and GP per output, stacked
        on a leading axis (kwargs as :meth:`compile_trainer`; ``mesh``: the
        outputs' mesh, None for the automatic one, False for none, or a
        ``DeviceMesh``)."""
        if self.correlated_output:
            raise NotImplementedError(
                "To compile a DKL-GP trainer for correlated outputs "
                "use compile_trainer(*args, **kwargs)")
        y = np.asarray(y) if not isinstance(y, torch.Tensor) else y
        if y.ndim < 2 or y.shape[0] < 2:
            raise ValueError(
                "The training targets must be vector-valued (d > 1)")
        self._compile(X, y, training_cycles, y.shape[0], not self.ensemble,
                      kwargs)

    def load_jax_params(self, fe_params, gp_params) -> None:
        """Loads a JAX ``dklGPTrainer``'s ``fe_params`` and ``gp_params``
        (nested dicts of arrays; a leading member axis for independent
        outputs) into this compiled trainer, restarts Adam and takes the
        embedding's statistics anew, so that both packages train and
        predict from the same weights."""
        from ..models.conversion import dkl_from_jax
        fe, gp = dkl_from_jax(fe_params, gp_params, self.dimdict)
        self.fe.load_state_dict(fe, strict=True)
        with torch.no_grad():
            for k, v in self.gp_params.items():
                v.copy_(gp[k].reshape(v.shape))
        self._reset_optimizer()
        self._compute_scale_stats()
        self._post_cache = None

    def _block_fe(self, X) -> torch.Tensor:
        """The extractor's output of this rank's block of outputs."""
        return self.fe(X) if self._block is None else \
            self.fe(X, self._block)

    def _block_gp(self):
        """(GP parameters, targets) of this rank's block of outputs."""
        if self._block is None:
            return self.gp_params, None
        return ({k: v[self._block] for k, v in self.gp_params.items()},
                self.y[self._block])

    def _loss_fn(self) -> torch.Tensor:
        gp, y = self._block_gp()
        with self.precision.tf32_scope():
            z = self._block_fe(self.X)
        with _FULL.tf32_scope():
            return self._gp_loss(gp, scale_to_bounds(z), y)

    def _loss_backward(self) -> torch.Tensor:
        with self.precision.tf32_scope(), \
                torch.set_grad_enabled(not self.freeze_weights):
            z = self._block_fe(self.X)
        zd = z.detach().requires_grad_(not self.freeze_weights)
        gp, y = self._block_gp()
        with _FULL.tf32_scope():
            loss = self._gp_loss(gp, scale_to_bounds(zd), y)
            loss.backward()
        if not self.freeze_weights:
            with self.precision.tf32_scope():
                z.backward(zd.grad)
        return loss

    def _run(self, X=None, y=None, training_cycles: int = 1, **kwargs):
        if not self.compiled:
            if self.correlated_output:
                self.compile_trainer(X, y, training_cycles, **kwargs)
            else:
                self.compile_multi_model_trainer(X, y, training_cycles,
                                                 **kwargs)
        super()._run(training_cycles=training_cycles, **kwargs)
        self._gather_outputs()
        self._compute_scale_stats()
        return self

    @torch.no_grad()
    def _gather_outputs(self) -> None:
        """Broadcasts every block of outputs (extractor and GP parameters)
        from the rank that trained it, and rank 0's loss history where the
        mesh leaves ranks out; where independent outputs found no mesh
        (and the caller did not ask for ``mesh=False``), every rank
        trained a replica of them all and takes rank 0's."""
        mesh = self.model_mesh
        if mesh is None:
            if not self.correlated_output:
                tensors = [v.data for v in self.gp_params.values()] + \
                    [p.data for p in self.fe.parameters()] + \
                    list(self.fe.buffers())
                self.train_loss = sync_from_rank0(None, tensors,
                                                  self.train_loss,
                                                  self._mesh_pref)
            return
        n_blocks = axis_size(mesh, MODEL_AXIS)
        per = self.y.shape[0] // n_blocks
        for j in range(n_blocks):
            rows = slice(j * per, (j + 1) * per)
            if isinstance(self.fe, StackedFeatureExtractor):
                fe = [p.data[rows] for p in self.fe.parameters()]
            else:
                fe = [t for m in self.fe.members[rows]
                      for t in m.state_dict().values()]
            broadcast_tensors(
                [v.data[rows] for v in self.gp_params.values()] + fe,
                block_owner(mesh, MODEL_AXIS, j))
        self.train_loss = sync_from_rank0(mesh, [], self.train_loss)

    @torch.no_grad()
    def predict(self, Xs, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance at new points in the learned
        embedding (the factorisation is recomputed per call; ``dklGPR``
        caches it)."""
        if self.fe is None:
            raise RuntimeError("Train the model first (run/compile)")
        Xs, _ = self.set_data(Xs)
        if self.scale_stats is None:
            self._compute_scale_stats()
        zt = self._embed(self.X, self.scale_stats)
        zs = self._embed(Xs, self.scale_stats)
        with _FULL.tf32_scope():
            cache = posterior_cache(self.gp_params, zt, self.y, self.kernel)
            m, v = posterior_from_cache(cache, zt, zs, self.kernel)
        return m.cpu().numpy(), v.cpu().numpy()

    def save_weights(self, filename: str) -> str:
        """Saves the feature extractor's weights (``model_type`` "dkl_fe";
        ``params`` is its ``state_dict``)."""
        return save_checkpoint(filename, {"model_type": "dkl_fe"},
                               {"params": self.fe.state_dict()})

    def load_weights(self, filename: str) -> None:
        """Loads a feature extractor's weights into this compiled trainer:
        a ``.aoit`` file of :meth:`save_weights`, or the JAX package's
        "dkl_fe" file (``.aoi``, its ``fe_params``), then takes the
        embedding's statistics anew."""
        from ..models.conversion import dkl_fe_from_jax
        if self.fe is None:
            raise RuntimeError("Compile the trainer before loading weights")
        _, arrays = load_checkpoint(filename)
        fe = dkl_fe_from_jax(arrays["params"], self.dimdict) \
            if is_jax_tree(arrays) else arrays["params"]
        self.fe.load_state_dict(fe, strict=True)
        self._compute_scale_stats()
        self._post_cache = None
