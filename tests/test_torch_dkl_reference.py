"""The port's ``dklGPR`` against the benchmark's plain reference
(``benchmark/reference/dkl.py``, imported by its path) at the published
widths (extractor 64 -> 1000 -> 500 -> 50 -> 2) from seeded random
weights, on the CPU at N = 64 training points and M = 512 candidates:
the negative MLL and its gradients, the draw's float64 posterior, and the
draw for a given noise. Then candidates dense enough that the posterior
formed in float32 does not factorise: the port's float64 draw is finite
and agrees with the reference's. And the training path's factorisation
still gives NaN, not an error, where a matrix is not positive definite.

Stated tolerances: float32 loss 1e-5 relative and gradients 1e-4
(relative L2 of each group: the same float32 arithmetic in another order,
through a Cholesky whose condition at these hyperparameters is at most
1 + N * outputscale / noise, about 1.3e3; measured 5e-7 and 1.6e-5); the
float64 posterior 1e-9 of its scale (the port expands the squared
distances into norms and a cross product, the reference takes
differences: rounding of 1e-16 grown by the solve; measured 1e-13); draws
1e-4 of the posterior standard deviation (the covariance's condition here
is about 1.6e6, so its float64 factor keeps ~1e-10 of it; measured
5e-7).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.models import dklGPR
from atomai_tpu_torch.models.dklgp import dklgpr
from atomai_tpu_torch.trainers import gptrainer

REF_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "reference", "dkl.py")
N, M, INDIM = 64, 512, 64
TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
TOL_POST, TOL_DRAW = 1e-9, 1e-4


def _load_ref():
    spec = importlib.util.spec_from_file_location("bench_reference_dkl",
                                                  REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_ref()


def _data(seed=0, m=M):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, INDIM).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.randn(N)).astype(np.float32)
    Xc = rng.randn(m, INDIM).astype(np.float32)
    return X, y, Xc


def _model(X, y, seed=3):
    """A compiled port model with seeded weights and GP hyperparameters
    away from their zero start."""
    m = dklGPR(INDIM, embedim=2, device="cpu", seed=seed)
    m.compile_trainer(X, y, training_cycles=1)
    with torch.no_grad():
        m.gp_params["raw_lengthscale"].copy_(torch.tensor([[0.3, -0.4]]))
        m.gp_params["raw_outputscale"].fill_(0.5)
        m.gp_params["raw_noise"].fill_(-3.0)
        m.gp_params["mean_const"].fill_(0.1)
    m._compute_scale_stats()
    return m


def _weights(m):
    return [(l.weight.detach().clone(), l.bias.detach().clone())
            for l in m.fe.layers]


def _gp(m):
    return {k: v.detach()[0].clone() for k, v in m.gp_params.items()}


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _grads(params):
    return torch.cat([p.grad.reshape(-1) for p in params])


def test_extractor_has_the_published_widths():
    m = _model(*_data()[:2])
    assert [l.out_features for l in m.fe.layers] == [1000, 500, 50, 2]
    assert sum(p.numel() for p in m.fe.parameters()) == 590652


def test_neg_mll_and_gradients_match_the_reference():
    X, y, _ = _data()
    m = _model(X, y)
    W, gp = _weights(m), _gp(m)
    loss = float(m._loss_backward().detach())
    g_gp = _grads(m.gp_params[k] for k in sorted(m.gp_params))
    g_fe = _grads(p for l in m.fe.layers for p in (l.weight, l.bias))
    W = [(w.requires_grad_(), b.requires_grad_()) for w, b in W]
    gp = {k: v.requires_grad_() for k, v in gp.items()}
    want = ref.neg_mll(W, gp, torch.from_numpy(X), torch.from_numpy(y))
    want.backward()
    want = float(want.detach())
    assert abs(loss - want) <= TOL_LOSS * abs(want)
    assert _rel(g_gp, torch.cat([gp[k].grad.reshape(-1)
                                 for k in sorted(gp)])) <= TOL_GRAD
    assert _rel(g_fe, torch.cat([t.grad.reshape(-1) for wb in W
                                 for t in wb])) <= TOL_GRAD


def _ref_posterior(m, X, y, Xc):
    z_t = torch.from_numpy(m.embed(X))
    z_c = torch.from_numpy(m.embed(Xc))
    return ref.posterior(z_t, torch.from_numpy(y), z_c, _gp(m),
                         torch.float64)


def test_float64_posterior_matches_the_reference():
    X, y, Xc = _data()
    m = _model(X, y)
    mean, cov = m._draw_posterior(torch.from_numpy(Xc))
    assert mean.dtype == cov.dtype == torch.float64
    assert cov.shape == (1, M, M)
    want_mean, want_cov = _ref_posterior(m, X, y, Xc)
    want_cov.diagonal().add_(ref.DRAW_JITTER)
    scale = float(want_cov.diagonal().max())
    assert float((mean[0] - want_mean).abs().max()) <= \
        TOL_POST * (1 + float(want_mean.abs().max()))
    assert float((cov[0] - want_cov).abs().max()) <= TOL_POST * scale


def _draw_gap(m, X, y, Xc, eps):
    got = m.sample_from_posterior(Xc, 1, eps=eps)
    assert got.dtype == np.float32 and got.shape == (1, 1, len(Xc))
    mean, cov = _ref_posterior(m, X, y, Xc)
    want, sd = ref.draw(mean, cov, eps.reshape(-1))
    assert torch.isfinite(want).all()
    return got, float((torch.from_numpy(got.reshape(-1)).double() - want)
                      .abs().div(sd).max())


def test_draw_with_given_noise_matches_the_reference():
    X, y, Xc = _data()
    m = _model(X, y)
    eps = torch.from_numpy(
        np.random.RandomState(5).randn(1, 1, M).astype(np.float32))
    got, gap = _draw_gap(m, X, y, Xc, eps)
    assert gap <= TOL_DRAW
    tsample, idx = m.thompson(Xc, eps=eps)
    np.testing.assert_array_equal(tsample, got[0])
    assert int(idx[0]) == int(np.argmax(got))


def _dense_candidates(X):
    """512 candidates: each of 16 measured points 32 times, most with a
    perturbation of 1e-4."""
    rng = np.random.RandomState(7)
    Xc = np.repeat(X[:16], 32, axis=0)
    Xc[::2] += 1e-4 * rng.randn(len(Xc[::2]), INDIM).astype(np.float32)
    return Xc


def test_dense_candidates_draw_finite_in_float64(monkeypatch):
    """Duplicated and nearly duplicated candidates: ``Kss - V^T V`` formed
    in float32 is not positive definite with the 1e-6 jitter (what the
    JAX package's draw gives here is not asserted); formed in float64 it
    factorises and the draw agrees with the reference's."""
    X, y, _ = _data()
    Xc = _dense_candidates(X)
    m = _model(X, y)
    eps = torch.from_numpy(
        np.random.RandomState(9).randn(1, 1, M).astype(np.float32))
    got, gap = _draw_gap(m, X, y, Xc, eps)
    assert np.isfinite(got).all() and gap <= TOL_DRAW
    monkeypatch.setattr(dklgpr, "DRAW_DTYPE", torch.float32)
    m._post_cache = None
    with pytest.raises(torch.linalg.LinAlgError, match="float32"):
        m.thompson(Xc, eps=eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_training_factor_is_nan_on_a_matrix_not_positive_definite(dtype):
    """The training path's ``_cholesky`` keeps the JAX package's contract
    (NaN, no error, no host sync) whatever the draw does."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=dtype)
    L = gptrainer._cholesky(bad)
    assert L.dtype == dtype and torch.isnan(torch.tril(L)).any()
    good = gptrainer._cholesky(torch.eye(2, dtype=dtype) * 4)
    torch.testing.assert_close(good, torch.eye(2, dtype=dtype) * 2)


# each span's children in a fit and a Thompson draw
GP_TREE = {"dkl.fit": {"dkl.upload", "dkl.fit.fetch"},
           "dkl.thompson": {"dkl.upload", "dkl.fetch"}}


@pytest.mark.parametrize("root", sorted(GP_TREE))
def test_fit_and_draw_spans_and_counters(root):
    X, y, Xc = _data(m=64)
    eps = torch.zeros(1, 1, len(Xc))

    def fit():
        m = dklGPR(INDIM, embedim=2, device="cpu", seed=1)
        m.fit(X, y, training_cycles=3, print_loss=2)
        return m
    m = fit()
    calls = {"dkl.fit": fit, "dkl.thompson": lambda: m.thompson(Xc, eps=eps)}
    with profile(activities=[ProfilerActivity.CPU]):
        calls[root]()
    records = profiling.spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == [root]
    for r in records:
        kids = {c.name for c in records if c.parent == r.id}
        assert kids == GP_TREE.get(r.name, set()), r.name
    stats = profiling.summary()["spans"]
    if root == "dkl.fit":
        assert stats["dkl.fit.fetch"]["count"] == 2       # chunks of 2, 1
    else:
        assert stats["dkl.fetch"]["count"] == 1


def test_exact_gp_records_no_spans():
    """Only deep kernel learning names its spans; an exact GP's fit
    records none."""
    X, y, _ = _data(m=8)
    gp = gptrainer.GPTrainer(device="cpu", seed=1)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        gp.run(X[:, :3], y, training_cycles=2, print_loss=1)
    assert profiling.spans() == []
