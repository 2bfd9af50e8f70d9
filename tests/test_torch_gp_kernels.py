"""The port's GP functions against the JAX package's, called directly on the
same numpy-made inputs (no fits): the kernels, ``kernel_diag`` (with a
user's kernel callable), ``scale_to_bounds``, the exact negative MLL, the
posteriors, the SGPR bound and posterior, ``make_inducing_grid``, and the
output-batched forms against ``jax.vmap``. Values and gradients with
respect to every raw parameter and the inputs; rbf and Matern, with and
without lengthscale constraints.

Stated tolerances, float32 on the CPU: values and gradients within 1e-5
of (1 + the largest magnitude of the JAX result) (measured: 1.5e-7 on the
MLL's gradients, 2.4e-7 on the posteriors); the SGPR posterior within
1e-4, since its gradients pass through the solves with Kmm's and B's
factors twice, and Kmm of inducing points that are training points 0.3
apart at lengthscales up to 3 keeps only ~1e-4 of float32's digits
(measured: 2.0e-5 on the gradient with respect to the inducing points);
``make_inducing_grid`` exactly equal; the transforms of raw parameters
within two float32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.nets import gp as jgp
from atomai_tpu.trainers import gptrainer as jgt
from atomai_tpu_torch.nets import gp as tgp
from atomai_tpu_torch.trainers import gptrainer as tgt

torch.set_num_threads(1)

TOL = 1e-5
TOL_SPARSE_POSTERIOR = 1e-4
N, M, D, B = 24, 7, 2, 3
KERNELS = ["rbf", "matern"]
CONSTRAINTS = [None, ([0.2, 0.3], [3.0, 4.0])]
CASES = [(k, c) for k in KERNELS for c in CONSTRAINTS]
CASE_IDS = [f"{k}-{'constrained' if c else 'free'}" for k, c in CASES]


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want)) if want.size else 0.0
    assert err <= tol * (1 + np.max(np.abs(want))), (what, err)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, D).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.randn(N)).astype(np.float32)
    return {
        "X": X, "y": y,
        "Xs": rng.randn(M, D).astype(np.float32),
        "Z": X[::3].copy(),
        "W": rng.randn(N, M).astype(np.float32),
        "params": {"raw_lengthscale": (0.3 * rng.randn(D)).astype(np.float32),
                   "raw_outputscale": np.float32(0.4),
                   "raw_noise": np.float32(-1.5),
                   "mean_const": np.float32(0.1)},
        "batched": {"raw_lengthscale":
                    (0.3 * rng.randn(B, D)).astype(np.float32),
                    "raw_outputscale": (0.2 * rng.randn(B))
                    .astype(np.float32),
                    "raw_noise": (-1 + 0.2 * rng.randn(B)).astype(np.float32),
                    "mean_const": (0.1 * rng.randn(B)).astype(np.float32)},
        "Y": (rng.randn(B, N)).astype(np.float32),
        "Xb": rng.randn(B, N, D).astype(np.float32),
    }


def _both(params, *arrays):
    """(jax params, jax arrays), (torch params, torch arrays) that require
    grad."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.tensor(a, requires_grad=True) for a in arrays]
    return (jp, ja), (tp, ta)


def _check_value_and_grads(jfn, tfn, params, arrays, what, tol=TOL):
    """``jfn``/``tfn`` map (params, *arrays) to a scalar; its value and
    gradients with respect to the params and the arrays must agree."""
    (jp, ja), (tp, ta) = _both(params, *arrays)
    jv, (jgp_, *jga) = jax.jit(jax.value_and_grad(jfn, argnums=tuple(
        range(1 + len(arrays)))))(jp, *ja)
    tv = tfn(tp, *ta)
    inputs = [*tp.values(), *ta]
    tg = [torch.zeros_like(x) if g is None else g for x, g in zip(
        inputs, torch.autograd.grad(tv, inputs, allow_unused=True))]
    _close(tv, jv, tol, what=f"{what} value")
    for k, g in zip(tp, tg):
        _close(g, jgp_[k], tol, what=f"{what} d/d{k}")
    for i, (g, w) in enumerate(zip(tg[len(tp):], jga)):
        _close(g, w, tol, what=f"{what} d/dinput{i}")


@pytest.mark.parametrize("kname,lc", CASES, ids=CASE_IDS)
def test_kernel_values_and_grads(data, kname, lc):
    W = data["W"]

    def jfn(p, x1, x2):
        ls, os_, _, _ = jgt._hyp(p, lc)
        return jnp.sum(W * jgp.KERNELS[kname](x1, x2, ls[None], os_[None])[0])

    def tfn(p, x1, x2):
        ls, os_, _, _ = tgt._hyp(p, lc)
        K = tgp.KERNELS[kname](x1, x2, ls[None], os_[None])[0]
        return torch.sum(torch.from_numpy(W) * K)

    _check_value_and_grads(jfn, tfn, data["params"],
                           [data["X"], data["Xs"]], kname)


def _doubled_jax(x1, x2, ls, os_):
    return 2.0 * jgp.rbf_kernel(x1, x2, ls, os_)


def _doubled_torch(x1, x2, ls, os_):
    return 2.0 * tgp.rbf_kernel(x1, x2, ls, os_)


@pytest.mark.parametrize("kind", ["rbf", "matern", "callable"])
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batched"])
def test_kernel_diag(data, kind, batched):
    """The built-in kernels' constant diagonal and a user's callable
    evaluated point by point, for one and for B outputs."""
    jk, tk = ((_doubled_jax, _doubled_torch) if kind == "callable"
              else (jgp.KERNELS[kind], tgp.KERNELS[kind]))
    p = data["batched" if batched else "params"]
    ls = jax.nn.softplus(jnp.asarray(p["raw_lengthscale"]))
    os_ = jax.nn.softplus(jnp.asarray(p["raw_outputscale"]))
    if not batched:
        ls, os_ = ls[None], os_[None]
    want = jgp.kernel_diag(jk, jnp.asarray(data["Xs"]), ls, os_)
    got = tgp.kernel_diag(tk, torch.from_numpy(data["Xs"]),
                          torch.from_numpy(np.array(ls)),
                          torch.from_numpy(np.array(os_)))
    _close(got, want, what="kernel_diag")
    if kind == "callable":
        _close(got, 2 * np.asarray(os_)[..., None].repeat(M, -1))


@pytest.mark.parametrize("with_stats", [False, True],
                         ids=["own", "train_stats"])
def test_scale_to_bounds_value_and_grad(data, with_stats):
    """Ties at the min and max spread the gradient evenly in both."""
    x = data["Xs"].copy()
    x[3] = x[np.argmin(x[:, 0]), 0], x[np.argmax(x[:, 1]), 1]  # ties
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    ref = data["X"][:5]

    def jfn(p, z):
        stats = jgp.compute_bounds_stats(jnp.asarray(ref)) if with_stats \
            else None
        return jnp.sum(w * jgp.scale_to_bounds(z, stats=stats))

    def tfn(p, z):
        stats = tgp.compute_bounds_stats(torch.from_numpy(ref)) \
            if with_stats else None
        return torch.sum(torch.from_numpy(w) * tgp.scale_to_bounds(
            z, stats=stats))

    _check_value_and_grads(jfn, tfn, {}, [x], "scale_to_bounds")


def test_raw_parameter_transforms():
    y = np.array([1e-8, 1e-3, 0.5, 3.0, 30.0], np.float32)
    np.testing.assert_allclose(tgp.inv_softplus(y).numpy(),
                               np.asarray(jgp.inv_softplus(y)), rtol=2e-7)
    raw = np.linspace(-5, 5, 11).astype(np.float32)
    np.testing.assert_allclose(
        tgp.constrain(torch.from_numpy(raw), 1.0, 4.0).numpy(),
        np.asarray(jgp.constrain(jnp.asarray(raw), 1.0, 4.0)), rtol=2e-7)
    np.testing.assert_allclose(
        tgp.constrain(torch.from_numpy(raw)).numpy(),
        np.asarray(jgp.constrain(jnp.asarray(raw))), rtol=2e-7)
    zeros = tgp.init_gp_params(3, (2,))
    want = jgp.init_gp_params(3, (2,))
    assert {k: tuple(v.shape) for k, v in zeros.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("kname,lc", CASES, ids=CASE_IDS)
def test_neg_mll(data, kname, lc):
    y = data["y"]

    def jfn(p, X):
        return jgt.neg_mll(p, X, jnp.asarray(y), jgp.KERNELS[kname], lc)

    def tfn(p, X):
        return tgt.neg_mll(p, X, torch.from_numpy(y), tgp.KERNELS[kname], lc)

    _check_value_and_grads(jfn, tfn, data["params"], [data["X"]], "neg_mll")


@pytest.mark.parametrize("kname,lc", CASES, ids=CASE_IDS)
def test_posteriors(data, kname, lc):
    """``posterior`` (variance and full covariance) and the cached pair,
    with a weighted sum of mean and variance differentiated."""
    y, W = data["y"], data["W"]
    wm, wv = W[0], W[1]

    def jfn(p, X, Xs):
        m, v = jgt.posterior(p, X, jnp.asarray(y), Xs, jgp.KERNELS[kname],
                             lc)
        return jnp.sum(wm * m + wv * v)

    def tfn(p, X, Xs):
        m, v = tgt.posterior(p, X, torch.from_numpy(y), Xs,
                             tgp.KERNELS[kname], lc)
        return torch.sum(torch.from_numpy(wm) * m + torch.from_numpy(wv) * v)

    _check_value_and_grads(jfn, tfn, data["params"],
                           [data["X"], data["Xs"]], "posterior")
    (jp, (jX, jXs)), (tp, (tX, tXs)) = _both(data["params"], data["X"],
                                             data["Xs"])
    jk, tk = jgp.KERNELS[kname], tgp.KERNELS[kname]
    with torch.no_grad():
        jc = jgt.posterior_cache(jp, jX, jnp.asarray(y), jk, lc)
        tc = tgt.posterior_cache(tp, tX, torch.from_numpy(y), tk, lc)
        assert sorted(jc) == sorted(tc)
        for k in jc:
            _close(tc[k], jc[k], what=f"cache {k}")
        for full_cov in (False, True):
            want = jgt.posterior_from_cache(jc, jX, jXs, jk, full_cov)
            got = tgt.posterior_from_cache(tc, tX, tXs, tk, full_cov)
            for g, w in zip(got, want):
                _close(g, w, what=f"from cache, full_cov={full_cov}")
        want = jgt.posterior(jp, jX, jnp.asarray(y), jXs, jk, lc, True)
        got = tgt.posterior(tp, tX, torch.from_numpy(y), tXs, tk, lc, True)
        for g, w in zip(got, want):
            _close(g, w, what="posterior full_cov")


@pytest.mark.parametrize("kname,lc", CASES, ids=CASE_IDS)
def test_sparse_bound_and_posterior(data, kname, lc):
    y, W = data["y"], data["W"]

    def jfn(p, X, Z):
        return jgt.neg_mll_sparse(p, X, jnp.asarray(y), Z,
                                  jgp.KERNELS[kname], lc)

    def tfn(p, X, Z):
        return tgt.neg_mll_sparse(p, X, torch.from_numpy(y), Z,
                                  tgp.KERNELS[kname], lc)

    _check_value_and_grads(jfn, tfn, data["params"], [data["X"], data["Z"]],
                           "neg_mll_sparse")

    def jpost(p, X, Z, Xs):
        c = jgt.sparse_posterior_cache(p, X, jnp.asarray(y), Z,
                                       jgp.KERNELS[kname], lc)
        m, v = jgt.sparse_posterior(c, Xs, jgp.KERNELS[kname])
        return jnp.sum(W[0] * m + W[1] * v)

    def tpost(p, X, Z, Xs):
        c = tgt.sparse_posterior_cache(p, X, torch.from_numpy(y), Z,
                                       tgp.KERNELS[kname], lc)
        m, v = tgt.sparse_posterior(c, Xs, tgp.KERNELS[kname])
        return torch.sum(torch.from_numpy(W[0]) * m
                         + torch.from_numpy(W[1]) * v)

    _check_value_and_grads(jpost, tpost, data["params"],
                           [data["X"], data["Z"], data["Xs"]],
                           "sparse posterior", TOL_SPARSE_POSTERIOR)


def test_custom_kernel_in_the_posterior_and_bound(data):
    """A user's kernel callable goes through ``kernel_diag``'s per-point
    path in the exact variance and the SGPR bound."""
    (jp, (jX, jXs, jZ)), (tp, (tX, tXs, tZ)) = _both(
        data["params"], data["X"], data["Xs"], data["Z"])
    y = data["y"]
    with torch.no_grad():
        for g, w in zip(
                tgt.posterior(tp, tX, torch.from_numpy(y), tXs,
                              _doubled_torch),
                jgt.posterior(jp, jX, jnp.asarray(y), jXs, _doubled_jax)):
            _close(g, w, what="custom kernel posterior")
        _close(tgt.neg_mll_sparse(tp, tX, torch.from_numpy(y), tZ,
                                  _doubled_torch),
               jgt.neg_mll_sparse(jp, jX, jnp.asarray(y), jZ, _doubled_jax),
               what="custom kernel SGPR bound")


@pytest.mark.parametrize("shared_inputs", [True, False],
                         ids=["shared_X", "batched_X"])
def test_output_batch_matches_vmap(data, shared_inputs):
    """B outputs at once (parameters with a leading axis) against
    ``jax.vmap`` of the one-output JAX functions."""
    X = data["X"] if shared_inputs else data["Xb"]
    Y, Xs, Z = data["Y"], data["Xs"], data["Z"]
    jk, tk = jgp.rbf_kernel, tgp.rbf_kernel
    jp = {k: jnp.asarray(v) for k, v in data["batched"].items()}
    tp = {k: torch.tensor(v) for k, v in data["batched"].items()}
    x_axis = None if shared_inputs else 0
    tX = torch.from_numpy(X)
    want = jax.vmap(lambda p, x, y: jgt.neg_mll(p, x, y, jk),
                    (0, x_axis, 0))(jp, jnp.asarray(X), jnp.asarray(Y))
    _close(tgt.neg_mll(tp, tX, torch.from_numpy(Y), tk), want,
           what="batched neg_mll")
    want = jax.vmap(lambda p, x, y: jgt.neg_mll_sparse(p, x, y, Z, jk),
                    (0, x_axis, 0))(jp, jnp.asarray(X), jnp.asarray(Y))
    _close(tgt.neg_mll_sparse(tp, tX, torch.from_numpy(Y),
                              torch.from_numpy(Z), tk), want,
           what="batched neg_mll_sparse")

    def jpost(p, x, y):
        c = jgt.posterior_cache(p, x, y, jk)
        return jgt.posterior_from_cache(c, x, jnp.asarray(Xs), jk)

    want = jax.vmap(jpost, (0, x_axis, 0))(jp, jnp.asarray(X),
                                           jnp.asarray(Y))
    cache = tgt.posterior_cache(tp, tX, torch.from_numpy(Y), tk)
    got = tgt.posterior_from_cache(cache, tX, torch.from_numpy(Xs), tk)
    for g, w in zip(got, want):
        _close(g, w, what="batched posterior")

    def jsparse(p, x, y):
        c = jgt.sparse_posterior_cache(p, x, y, Z, jk)
        return jgt.sparse_posterior(c, jnp.asarray(Xs), jk)

    want = jax.vmap(jsparse, (0, x_axis, 0))(jp, jnp.asarray(X),
                                             jnp.asarray(Y))
    cache = tgt.sparse_posterior_cache(tp, tX, torch.from_numpy(Y),
                                       torch.from_numpy(Z), tk)
    got = tgt.sparse_posterior(cache, torch.from_numpy(Xs), tk)
    for g, w in zip(got, want):
        _close(g, w, what="batched sparse posterior")


@pytest.mark.parametrize("n,d,ratio,max_points", [
    (60, 2, 1.0, 1024), (60, 2, 0.25, 1024), (3000, 2, 1.0, 1024),
    (500, 3, 0.5, 200), (5, 2, 1.0, 1024)])
def test_make_inducing_grid(n, d, ratio, max_points):
    X = np.random.RandomState(n).uniform(-3, 7, (n, d)).astype(np.float32)
    want = np.asarray(jgt.make_inducing_grid(X, ratio, max_points))
    got = tgt.make_inducing_grid(torch.from_numpy(X), ratio, max_points)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_failed_factorisation_is_nan_without_raising():
    """A matrix that is not positive definite gives a NaN lower triangle
    (all that the solves read), as ``jnp.linalg.cholesky`` does, instead of
    an error; the other matrices of the batch are factorised."""
    bad = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]])
    L = tgt._cholesky(bad)
    lower = np.tril(np.ones((2, 2), bool))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad.numpy())))
    assert np.isnan(want[0][lower]).all()
    assert torch.isnan(L[0][torch.from_numpy(lower)]).all()
    _close(L[1], want[1])
