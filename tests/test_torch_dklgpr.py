"""The port's deep-kernel-learning GP against the JAX package's, from the
same weights (carried by ``dkl_from_jax``) and numpy-made data: a shared
embedding, independent outputs (the JAX arm shards its 4 members over the
test session's 8 virtual CPU devices), an ensemble, frozen extractor
weights; then, from the JAX run's final weights, ``predict`` (batch
independent), ``embed``, ``sample_from_posterior`` and ``thompson`` with
the same noise, and the trainer-level ``predict``. Also
``GPRegressionModel`` and ``CustomGPModel``, the ``save_weights`` round
trip, the bridge's checks, and the TF32 switches in the two-stage
backward. Each JAX run happens once, in a module-scoped fixture. The
extractor is the fc one at narrow widths (8 -> 16 -> 8 -> 2).

Stated tolerances, float32 on the CPU: weights within 2 * lr * steps
(Adam moves a weight by about lr a step, so a gradient of rounding size,
as a nearly dead ReLU unit's, may move it either way); losses 1e-3
relative (the first three steps agree within 1.2e-6, then one such step
moves the shared run's loss by 2.0e-4); from the same weights,
predictions and embeddings within 1e-5 of (1 + their largest magnitude)
(measured: 6e-7), the models' forward passes and posteriors within 1e-5;
posterior draws within 1e-3, since the posterior covariance of test
points near the training points is nearly singular (1e-6 jitter) and its
float32 Cholesky factor keeps ~1e-4 of it (measured: 1.4e-4).
"""

import contextlib
import functools
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models import dklGPR as JaxDKL
from atomai_tpu.nets import gp as jgp
from atomai_tpu.trainers import dklGPTrainer as JaxDKLTrainer
from atomai_tpu_torch.core import Precision, load_checkpoint
from atomai_tpu_torch.models import dkl_from_jax, dklGPR
from atomai_tpu_torch.nets import gp as tgp
from atomai_tpu_torch.trainers import dklGPTrainer

torch.set_num_threads(1)

INDIM, EMBEDIM, HIDDEN = 8, 2, (16, 8)
CYCLES, LR = 4, 0.01
TOL_LOSS_REL = 1e-3
TOL_ADAM = 2 * LR * CYCLES
TOL = 1e-5
TOL_DRAWS = 1e-3
N_OUT = 4


def _jax_fe():
    return functools.partial(jgp.fcFeatureExtractor, hidden_dim=HIDDEN)


def _port_fe():
    return functools.partial(tgp.fcFeatureExtractor, hidden_dim=HIDDEN)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * (1 + np.max(np.abs(want))), (what, err)


@contextlib.contextmanager
def _quiet():
    with contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(40, INDIM).astype(np.float32)
    y = (X[:, 0] + 0.5 * np.sin(X[:, 1]) + 0.05 * rng.randn(40)).astype(
        np.float32)
    Y = np.stack([y, -y, X[:, 2], X[:, 0] * X[:, 1]]).astype(np.float32)
    Xt = rng.randn(6, INDIM).astype(np.float32)
    return X, y, Y, Xt


def _compile(model, X, y, mode, **kw):
    """Compiles ``model`` as ``mode`` ('shared', 'independent',
    'ensemble', 'frozen') runs it."""
    if mode == "ensemble":
        model.correlated_output, model.ensemble = False, True
        y = np.repeat(np.asarray(y)[None], N_OUT, axis=0)
    if mode in ("independent", "ensemble"):
        model.compile_multi_model_trainer(X, y, CYCLES, lr=LR, **kw)
    else:
        model.compile_trainer(X, y, CYCLES, lr=LR,
                              freeze_weights=mode == "frozen", **kw)


def _pair(data, mode):
    """(JAX model, port model, initial JAX weights), both trained for
    CYCLES Adam steps from the same weights."""
    X, y, Y, _ = data
    target = Y if mode == "independent" else y
    shared = mode in ("shared", "frozen")
    j = JaxDKL(INDIM, embedim=EMBEDIM, shared_embedding_space=shared)
    _compile(j, X, target, mode, feature_extractor=_jax_fe())
    init = (_np(j.fe_params), _np(j.gp_params))
    t = dklGPR(INDIM, embedim=EMBEDIM, shared_embedding_space=shared,
               device="cpu")
    _compile(t, X, target, mode, feature_extractor=_port_fe())
    t.load_jax_params(*init)
    with _quiet():
        j.run(print_loss=3)
        t.run(print_loss=3)
    return j, t, init


@pytest.fixture(scope="module")
def runs(data):
    return {mode: _pair(data, mode)
            for mode in ("shared", "independent", "ensemble", "frozen")}


def _port_weights(t):
    """The port's extractor and GP weights as JAX-layout trees."""
    fe = t.fe
    if isinstance(fe, tgp.StackedFeatureExtractor):
        tree = {f"Dense_{i}": {"kernel": k.detach().numpy(),
                               "bias": b.detach().numpy()}
                for i, (k, b) in enumerate(zip(fe.kernels, fe.biases))}
    else:
        tree = {f"Dense_{i}": {"kernel": layer.weight.detach().numpy().T,
                               "bias": layer.bias.detach().numpy()}
                for i, layer in enumerate(fe.layers)}
    return tree, {k: v.detach().numpy() for k, v in t.gp_params.items()}


@pytest.mark.parametrize("mode",
                         ["shared", "independent", "ensemble", "frozen"])
def test_training_matches_jax(runs, mode):
    j, t, (fe0, _) = runs[mode]
    assert len(t.train_loss) == CYCLES
    np.testing.assert_allclose(t.train_loss, j.train_loss, rtol=TOL_LOSS_REL)
    fe, gp = _port_weights(t)
    want_fe, want_gp = _np(j.fe_params), _np(j.gp_params)
    for k in gp:
        np.testing.assert_allclose(gp[k], want_gp[k], atol=TOL_ADAM)
    for name in fe:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(fe[name][leaf], want_fe[name][leaf],
                                       atol=TOL_ADAM)
            if mode == "frozen":
                np.testing.assert_array_equal(fe[name][leaf],
                                              fe0[name][leaf])
    if mode == "independent":
        # identical copies at the start, as the JAX package's
        k0 = fe0["Dense_0"]["kernel"]
        assert all(np.array_equal(k0[0], k0[i]) for i in range(N_OUT))
    if mode == "ensemble":
        k0 = fe0["Dense_0"]["kernel"]
        assert not np.array_equal(k0[0], k0[1])


def _load_final(j, t):
    """The JAX run's final weights into the port model."""
    t.load_jax_params(_np(j.fe_params), _np(j.gp_params))


@pytest.mark.parametrize("mode", ["shared", "independent", "ensemble"])
def test_posterior_from_the_same_weights(data, runs, mode):
    """The ensemble runs the independent outputs' posterior code: only its
    embedding's layout, (n, embedim, b), differs."""
    X, _, _, Xt = data
    j, t, _ = runs[mode]
    _load_final(j, t)
    _close(t.embed(Xt), j.embed(Xt), what="embed")
    if mode == "ensemble":
        return
    for batch in ({}, {"batch_size": 4}):
        for got, want in zip(t.predict(Xt, **batch), j.predict(Xt, **batch)):
            _close(got, want, what=f"predict {batch}")
    got = dklGPTrainer.predict(t, Xt)
    want = JaxDKLTrainer.predict(j, Xt)
    for g, w in zip(got, want):
        _close(g, w, what="trainer-level predict")


def test_predict_does_not_depend_on_the_batch(data, runs):
    _, _, _, Xt = data
    t = runs["shared"][1]
    mean, var = t.predict(Xt + 0.1)
    m1, v1 = t.predict(Xt + 0.1, batch_size=1)
    _close(m1, mean)
    _close(v1, var)
    assert np.std(m1) > 1e-6
    _close(np.concatenate([t.embed(Xt[i:i + 1]) for i in range(len(Xt))]),
           t.embed(Xt))


@pytest.mark.parametrize("mode,scalarize", [("shared", None),
                                            ("independent", "mean")])
def test_posterior_draws_with_the_same_noise(data, runs, monkeypatch,
                                             mode, scalarize):
    """``sample_from_posterior`` and ``thompson`` push the same standard
    normal noise through both packages."""
    X, _, _, Xt = data
    j, t, _ = runs[mode]
    _load_final(j, t)
    b = N_OUT if mode == "independent" else 1
    eps = np.random.RandomState(3).randn(5, b, len(Xt)).astype(np.float32)
    calls = []

    def normal(key, shape):
        calls.append(shape)
        return jnp.asarray(eps[:shape[0]])

    monkeypatch.setattr(jax.random, "normal", normal)
    _close(t.sample_from_posterior(Xt, 5, eps=torch.from_numpy(eps)),
           j.sample_from_posterior(Xt, 5), TOL_DRAWS, what="samples")
    fn = (lambda s: s.mean(0)) if scalarize else None
    got, got_idx = t.thompson(Xt, scalarize_func=fn,
                              eps=torch.from_numpy(eps[:1]))
    want, want_idx = j.thompson(Xt, scalarize_func=fn)
    _close(got, want, TOL_DRAWS, what="thompson draw")
    np.testing.assert_array_equal(got_idx, want_idx)
    assert calls == [(5, b, len(Xt)), (1, b, len(Xt))]
    draws = t.sample_from_posterior(Xt, 3)
    assert draws.shape == (3, b, len(Xt)) and np.isfinite(draws).all()


def test_fit_ensemble_draws_independent_members(data):
    X, y, Y, Xt = data
    m = dklGPR(INDIM, embedim=EMBEDIM, device="cpu")
    with pytest.warns(UserWarning, match="independent"):
        with contextlib.redirect_stdout(io.StringIO()):
            m.fit_ensemble(X, y, training_cycles=2, n_models=3,
                           print_loss=2, feature_extractor=_port_fe())
    assert isinstance(m.fe, tgp.StackedFeatureExtractor)
    k = m.fe.kernels[0].detach()
    assert not torch.equal(k[0], k[1])
    assert m.embed(Xt).shape == (len(Xt), EMBEDIM, 3)
    assert m.predict(Xt)[0].shape == (3, len(Xt))
    with pytest.raises(NotImplementedError):
        dklGPR(INDIM, device="cpu").fit_ensemble(X, Y, 1)


def test_save_weights_round_trip(data, runs, tmp_path):
    t = runs["independent"][1]
    path = t.save_weights(str(tmp_path / "fe"))
    meta, arrays = load_checkpoint(path)
    assert meta == {"model_type": "dkl_fe"}
    fresh = tgp.StackedFeatureExtractor(N_OUT, INDIM, EMBEDIM, HIDDEN)
    fresh.load_state_dict(arrays["params"])
    x = torch.from_numpy(data[3])
    torch.testing.assert_close(fresh(x), t.fe(x), rtol=0, atol=0)


def test_dkl_from_jax_checks_the_tree(runs):
    j = runs["shared"][0]
    fe, gp = _np(j.fe_params), _np(j.gp_params)
    state, params = dkl_from_jax(fe, gp, {"input_dim": INDIM,
                                          "embedim": EMBEDIM})
    assert sorted(state) == sorted(
        f"layers.{i}.{w}" for i in range(3) for w in ("weight", "bias"))
    np.testing.assert_array_equal(state["layers.0.weight"].numpy(),
                                  fe["Dense_0"]["kernel"].T)
    assert sorted(params) == sorted(gp)
    with pytest.raises(ValueError, match="do not map"):
        dkl_from_jax(fe, gp, {"input_dim": INDIM + 1, "embedim": EMBEDIM})
    with pytest.raises(ValueError, match="GP"):
        dkl_from_jax(fe, {"raw_noise": gp["raw_noise"]},
                     {"input_dim": INDIM, "embedim": EMBEDIM})


def test_mesh_raises(data):
    X, y, _, _ = data
    with pytest.raises(NotImplementedError, match="#21"):
        dklGPR(INDIM, device="cpu").compile_trainer(X, y, mesh=object())


def test_gp_regression_model_matches_jax(data):
    X, y, _, Xt = data
    jm = jgp.GPRegressionModel(X, y, feature_extractor=jgp.fcFeatureExtractor(
        INDIM, EMBEDIM, HIDDEN))
    jp = jm.init(jax.random.key(0))
    jp["gp"] = {k: v + 0.1 * (i + 1) for i, (k, v) in
                enumerate(sorted(jp["gp"].items()))}
    tm = tgp.GPRegressionModel(X, y, feature_extractor=tgp.fcFeatureExtractor(
        INDIM, EMBEDIM, HIDDEN), device="cpu")
    fe, gp = dkl_from_jax(_np(jp["fe"]), _np(jp["gp"]),
                          {"input_dim": INDIM, "embedim": EMBEDIM})
    tp = {"fe": fe, "gp": gp}
    for got, want in zip(tm.forward(tp, Xt), jm.forward(jp, jnp.asarray(Xt))):
        _close(got.detach(), want, what="GPRegressionModel forward")
    for got, want in zip(tm.train_stats(tp), jm.train_stats(jp)):
        _close(got.detach(), want, what="train_stats")
    assert set(tm.init()) == {"fe", "gp"}


@pytest.mark.parametrize("kernel_type", ["exact", "sparse", "kissgp"])
def test_custom_gp_model_matches_jax(data, kernel_type):
    X, y, _, Xt = data
    X2, Xt2 = X[:, :2], Xt[:, :2]
    kw = dict(kernel_type=kernel_type, base_kernel="matern",
              lengthscale_constraints=[[0.2, 0.2], [4.0, 4.0]],
              grid_points_ratio=0.3)
    if kernel_type == "sparse":
        kw["inducing_points"] = X2[::4]
    jm = jgp.CustomGPModel(X2, y, **kw)
    tm = tgp.CustomGPModel(X2, y, device="cpu", **kw)
    jp = {k: v + 0.2 for k, v in jm.init().items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    posterior = jax.jit(jm.posterior, static_argnames="full_cov")
    _close(tm.neg_mll(tp), jax.jit(jm.neg_mll)(jp), what="neg_mll")
    for got, want in zip(tm.posterior(tp, Xt2), posterior(jp, Xt2)):
        _close(got, want, what="posterior")
    for got, want in zip(tm.forward(tp, Xt2), jax.jit(jm.forward)(jp, Xt2)):
        _close(got, want, what="forward")
    if kernel_type == "exact":
        for got, want in zip(tm.posterior(tp, Xt2, full_cov=True),
                             posterior(jp, Xt2, full_cov=True)):
            _close(got, want, what="full covariance")


def _record_tf32(seen, tag):
    def hook(grad):
        seen.append((tag, torch.backends.cuda.matmul.allow_tf32))
    return hook


def test_gp_backward_runs_with_tf32_off(data, monkeypatch):
    """Under the mixed policy (TF32 allowed for the extractor) the kernel
    matrices, factorisations and solves run with TF32 off, forward and
    backward, and the extractor's backward under the policy's switch; the
    switches are put back afterwards."""
    X, y, _, _ = data
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def kernel(x1, x2, ls, os_):
        seen.append(("gp forward", torch.backends.cuda.matmul.allow_tf32))
        K = tgp.rbf_kernel(x1, x2, ls, os_)
        if K.requires_grad:
            K.register_hook(_record_tf32(seen, "gp backward"))
        return K

    m = dklGPR(INDIM, embedim=EMBEDIM, device="cpu")
    m.compile_trainer(X, y, training_cycles=1,
                      feature_extractor=_port_fe())
    m.precision = Precision.mixed()
    m.kernel = kernel

    def fe_hook(mod, inputs, out):
        seen.append(("fe forward", torch.backends.cuda.matmul.allow_tf32))
        if out.requires_grad:
            out.register_hook(_record_tf32(seen, "fe backward"))
    m.fe.layers[0].register_forward_hook(fe_hook)
    with contextlib.redirect_stdout(io.StringIO()):
        m.run(print_loss=1)
    assert ("gp forward", False) in seen and ("gp backward", False) in seen
    assert ("fe forward", True) in seen and ("fe backward", True) in seen
    assert not any(s for tag, s in seen if tag.startswith("gp"))
    assert torch.backends.cuda.matmul.allow_tf32 is True
