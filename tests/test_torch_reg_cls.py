"""The port's Regressor, Classifier and DenoisingAutoencoder against the JAX
package's: ``fit`` from the same weights (carried by ``reg_cls_from_jax``
and ``denoiser_from_jax``) on the same data and batch schedule,
``predict`` on the same weights, ``save_model`` -> ``load_model`` round
trips, the argument orders, ``preprocess_denoiser_data`` and
``denoise_images``.

Stated tolerances, float32 on the CPU:
- three Adam(1e-3) cycles: weights within 2 * lr * steps (Adam moves a
  weight by about lr a step whatever its gradient's size, so a rounding-
  size gradient that takes the other sign in the other package separates
  the two by 2 * lr); the first train loss (the same weights) 1e-4
  relative, the later ones, which those weights move, 1e-2 (measured
  <= 1.3e-3, MobileNet-slim's second); accuracies equal;
- the eval-mode test losses and ``predict`` after ``fit`` go through
  BatchNorm running variances that differ by n / (n - 1) (flax updates
  them with the biased batch variance, torch with the unbiased one); the
  slim presets' last BatchNorm averages over n = 8 x 2 x 2 = 32 values at
  64 x 64, so after three updates its running variances differ by up to
  (1 - 0.9^3) / 31 = 8.7e-3 relative: 1e-2 relative on the test losses
  and the predictions (measured <= 2.2e-3 and 6.0e-3);
- the running means and variances, statistics of activations that the
  Adam-separated weights feed (the slim presets' last conv has weights of
  scale 1 / sqrt(2304) = 0.02, so 2 * lr * steps is a third of it): 1e-1
  over their largest |value| (measured <= 3.2e-2, MobileNet-slim's last
  running mean);
- ``predict`` on the same weights: 1e-5 over the largest |value|.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models import Classifier as JaxClassifier
from atomai_tpu.models import DenoisingAutoencoder as JaxDenoiser
from atomai_tpu.models import Regressor as JaxRegressor
from atomai_tpu.models.denoiser import \
    preprocess_denoiser_data as jax_preprocess_denoiser_data
from atomai_tpu_torch.models import (Classifier, DenoisingAutoencoder,
                                     Regressor, denoise_images,
                                     denoiser_from_jax,
                                     init_denoising_autoencoder,
                                     load_cls_model,
                                     load_denoising_autoencoder,
                                     load_model, load_reg_model,
                                     reg_cls_from_jax)
from atomai_tpu_torch.models.denoiser import preprocess_denoiser_data
from atomai_tpu_torch.transforms import reg_augmentor

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

LR, CYCLES = 1e-3, 3
TOL_ADAM = 2 * LR * CYCLES
RTOL_FIRST_LOSS = 1e-4
RTOL_ADAM_LOSS = 1e-2
RTOL_BN = 1e-2
RTOL_ADAM_STATS = 1e-1
TOL_PREDICT = 1e-5
DENOISER = dict(encoder_filters=(4, 8), decoder_filters=(8, 4),
                encoder_layers=(1, 2), decoder_layers=(2, 1))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _data(n=24, size=64, seed=0):
    """Noisy ramps: the slope is the regression target, its sign half the
    classes."""
    rng = np.random.RandomState(seed)
    slope = rng.rand(n).astype(np.float32) * 2 - 1
    ramp = np.linspace(0, 1, size, dtype=np.float32)[None, None]
    X = (slope[:, None, None] * ramp + 0.2 * rng.rand(n, size, size))
    return X.astype(np.float32), slope, (slope > 0).astype(np.int64)


def _seeded(jnet, x):
    script = chip_smoke.fixture_script()
    v = script.seeded_variables(script.variable_shapes(jnet, x))
    return script.unflatten(v, "params"), script.unflatten(v, "batch_stats")


MODELS = {
    "regressor": (JaxRegressor, Regressor, ("mobilenet-slim", 1), 1),
    "classifier": (JaxClassifier, Classifier, ("vgg-slim", 2), 2),
    "denoiser": (JaxDenoiser, DenoisingAutoencoder, (), 3),
}


def _targets(kind, X, y, lab):
    return {"regressor": y, "classifier": lab, "denoiser": X}[kind]


def _inputs(kind, X):
    if kind != "denoiser":
        return X
    return X + 0.1 * np.random.RandomState(5).randn(*X.shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=sorted(MODELS))
def fitted(request, tmp_path_factory):
    """(kind, JAX model, port model, held-out inputs) trained from the
    same weights."""
    kind = request.param
    jcls, tcls, args, seed = MODELS[kind]
    tmp = tmp_path_factory.mktemp(kind)
    X, y, lab = _data(seed=seed)
    inp, tgt = _inputs(kind, X), _targets(kind, X, y, lab)
    kw = DENOISER if kind == "denoiser" else {}
    jm = jcls(*args, **kw)
    jm.params, stats = _seeded(jm.net, inp[:1, ..., None])
    jm.batch_stats = stats or None
    pm = tcls(*args, device="cpu", **kw)
    pm.load_jax_variables(jm.params, jm.batch_stats)
    fit = dict(training_cycles=CYCLES, batch_size=8, print_loss=CYCLES)
    jm.fit(inp[:16], tgt[:16], inp[16:], tgt[16:], filename=str(tmp / "j"),
           mesh=False, **fit)
    pm.fit(inp[:16], tgt[:16], inp[16:], tgt[16:], filename=str(tmp / "p"),
           **fit)
    return kind, jm, pm, inp[16:]


def test_fit_matches_jax(fitted):
    kind, jm, pm, _ = fitted
    np.testing.assert_array_equal(pm.batch_idx_train, jm.batch_idx_train)
    got, want = pm.loss_acc["train_loss"], jm.loss_acc["train_loss"]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL_FIRST_LOSS)
    np.testing.assert_allclose(got, want, rtol=RTOL_ADAM_LOSS)
    np.testing.assert_allclose(pm.loss_acc["test_loss"],
                               jm.loss_acc["test_loss"], rtol=RTOL_BN)
    for k in ("train_accuracy", "test_accuracy"):
        assert len(pm.loss_acc[k]) == len(jm.loss_acc[k]) == (
            CYCLES if kind == "classifier" else 0)
        np.testing.assert_array_equal(pm.loss_acc[k], jm.loss_acc[k])
    bridge = denoiser_from_jax if kind == "denoiser" else reg_cls_from_jax
    want = bridge(_np(jm.params), _np(jm.batch_stats or {}),
                  pm.meta_state_dict)
    got = pm.net.state_dict()
    means = {k for k in want if k.endswith("running_mean")}
    errs, tols = {}, {}
    chip_smoke.state_errors(got, {k: v for k, v in want.items()
                                  if k not in means}, TOL_ADAM, errs, tols,
                            RTOL_ADAM_STATS)
    assert len(errs) > 4 and not chip_smoke.failures(errs, tols)
    for k in means:
        err = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        assert err <= RTOL_ADAM_STATS, (k, err)


def test_predict_after_fit_matches_jax(fitted):
    kind, jm, pm, Xt = fitted
    kw = {} if kind == "denoiser" else {"verbose": False}
    want, got = jm.predict(Xt, **kw), pm.predict(Xt, **kw)
    assert got.shape == want.shape == ((8,) if kind != "denoiser"
                                       else (8, 64, 64))
    if kind == "classifier":
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= RTOL_BN, err


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_predict_on_the_same_weights_matches_jax(kind):
    """Normalisation, chunks (``num_batches`` with a remainder),
    ``norm=False``, a single 2-D image, the argmax of the classifier."""
    jcls, tcls, args, _ = MODELS[kind]
    jm = jcls(*args)
    X = _data(n=7, size=32, seed=4)[0] * 3
    jm.params, jm.batch_stats = _seeded(jm.net, X[:1, ..., None])
    pm = tcls(*args, device="cpu")
    pm.load_jax_variables(jm.params, jm.batch_stats)
    for kw in ({}, {"num_batches": 3}, {"norm": False}):
        want = jm.predict(X, verbose=False, **kw)
        got = pm.predict(X, verbose=False, **kw)
        assert got.shape == want.shape == (7,)
        if kind == "classifier":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PREDICT
                                       * np.abs(want).max())
    single = pm.predict(X[0], verbose=False)
    assert single.shape == () and np.isfinite(single)


def test_denoiser_predict_on_the_same_weights_matches_jax():
    jm = JaxDenoiser(**DENOISER)
    X = _data(n=5, size=32, seed=6)[0]
    jm.params, _ = _seeded(jm.net, X[:1, ..., None])
    pm = DenoisingAutoencoder(device="cpu", **DENOISER)
    pm.load_jax_variables(jm.params)
    for x in (X, X[0], X[:, None]):
        want, got = jm.predict(x), pm.predict(x, num_batches=2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PREDICT *
                                   np.abs(want).max())


def test_preprocess_denoiser_data_matches_jax():
    rng = np.random.RandomState(0)
    for shapes in (((16, 16),) * 4, ((3, 16, 16),) * 4,
                   ((3, 1, 16, 16), (3, 16, 16, 1), (2, 16, 16),
                    (2, 16, 16))):
        arrays = [rng.rand(*s) for s in shapes]
        for got, want in zip(preprocess_denoiser_data(*arrays),
                             jax_preprocess_denoiser_data(*arrays)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_save_model_load_model_round_trip(kind, tmp_path):
    _, tcls, args, _ = MODELS[kind]
    X, y, lab = _data(n=12, size=32)
    inp, tgt = _inputs(kind, X), _targets(kind, X, y, lab)
    kw = DENOISER if kind == "denoiser" else {}
    m = tcls(*args, device="cpu", **kw)
    m.fit(inp, tgt, training_cycles=2, batch_size=4, print_loss=2,
          filename=str(tmp_path / "fit"))
    path = m.save_model(str(tmp_path / "saved"))
    typed = {"regressor": load_reg_model, "classifier": load_cls_model,
             "denoiser": load_denoising_autoencoder}[kind]
    for m2 in (load_model(path, device="cpu"), typed(path, device="cpu")):
        assert type(m2) is tcls
        assert m2.meta_state_dict == m.meta_state_dict
        for a, b in zip(m.net.state_dict().values(),
                        m2.net.state_dict().values()):
            assert torch.equal(a, b)
    other = {"regressor": load_cls_model, "classifier": load_reg_model,
             "denoiser": load_reg_model}[kind]
    with pytest.raises(ValueError, match="not a"):
        other(path, device="cpu")
    m3 = tcls(*args, device="cpu", seed=9, **kw)
    m3.load_weights(path)
    np.testing.assert_array_equal(m3.predict(inp[:3]), m.predict(inp[:3]))


def test_argument_orders_and_metadicts_match_jax():
    """The reference order ``(backbone, count)``, the legacy ``(count,
    backbone)`` and the ``backbone=`` keyword build the same models."""
    for tcls, jcls, key in ((Regressor, JaxRegressor, "out_dim"),
                            (Classifier, JaxClassifier, "nb_classes")):
        for args, kw in ((("vgg-slim", 3), {}), ((3, "vgg-slim"), {}),
                         ((3,), {"backbone": "vgg-slim"})):
            m = tcls(*args, device="cpu", **kw)
            assert m.meta_state_dict == jcls(*args, **kw).meta_state_dict
            assert m.meta_state_dict["backbone"] == "vgg-slim"
            assert m.meta_state_dict[key] == 3
    with pytest.raises(AssertionError, match="nb_classes"):
        Classifier("vgg-slim", device="cpu")
    assert Regressor(device="cpu", input_channels=2).meta_state_dict[
        "in_channels"] == 2
    d = DenoisingAutoencoder(device="cpu", **DENOISER)
    assert d.meta_state_dict == JaxDenoiser(**DENOISER).meta_state_dict
    net, meta = init_denoising_autoencoder(**DENOISER)
    assert meta == d.meta_state_dict
    assert all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), d.net.state_dict().values()))


def test_labels_and_targets_are_staged_as_jax_does():
    X, y, lab = _data(n=10, size=32)
    r = Regressor("vgg-slim", 1, device="cpu")
    r.compile_trainer((X, y), loss="mse", training_cycles=1, batch_size=4,
                      filename="unused")
    assert r.yb_train.shape[-1] == 1 and r.yb_train.dtype == torch.float32
    assert r.Xb_train.shape[-3:] == (32, 32, 1)
    c = Classifier("vgg-slim", 2, device="cpu")
    c.compile_trainer((X, lab, X[:4], lab[:4]), loss="nll",
                      training_cycles=1, batch_size=4, filename="unused")
    assert c.yb_train.dtype == torch.int64 and c.yb_train.ndim == 2
    probs = torch.log(torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]]))
    assert float(c.accuracy_fn(torch.tensor([0, 1, 1]), probs)) == \
        pytest.approx(2 / 3)


def test_reg_augmentor_leaves_targets_and_geometry():
    assert reg_augmentor() is None
    assert reg_augmentor(rotation=True, zoom=True) is None
    aug = reg_augmentor(gauss_noise=[20, 21], contrast=True)
    X = torch.from_numpy(_data(n=4, size=32)[0])[..., None]
    y = torch.arange(4.0)[:, None]
    g = torch.Generator().manual_seed(0)
    Xa, ya = aug(g, X, y)
    assert Xa.shape == X.shape and torch.equal(ya, y)
    assert not torch.equal(Xa, X)
    assert float(Xa.min()) == 0.0 and float(Xa.max()) == 1.0


def test_fit_with_augmentation_runs(tmp_path):
    X, y, _ = _data(n=12, size=32)
    m = Regressor("mobilenet-slim", 1, device="cpu")
    m.fit(X, y, training_cycles=2, batch_size=4, print_loss=2,
          gauss_noise=[10, 20], blur=True, filename=str(tmp_path / "aug"))
    assert m.augment_fn is not None
    assert np.isfinite(m.loss_acc["train_loss"]).all()


def test_denoise_images(tmp_path):
    X = _data(n=16, size=32, seed=2)[0]
    noisy = _inputs("denoiser", X)
    model, pred = denoise_images(noisy[:12], X[:12], noisy[12:], X[12:],
                                 training_cycles=2, batch_size=4,
                                 device="cpu", print_loss=2,
                                 filename=str(tmp_path / "den"),
                                 **DENOISER)
    assert isinstance(model, DenoisingAutoencoder)
    assert pred.shape == (4, 32, 32) and np.isfinite(pred).all()
    np.testing.assert_array_equal(pred, model.predict(noisy[12:]))
    assert model.running_weights_stats is not None     # SWA on by default
    _, none = denoise_images(noisy[:12], X[:12], training_cycles=1,
                             batch_size=4, device="cpu",
                             filename=str(tmp_path / "den2"), **DENOISER)
    assert none is None
