"""The port's deep ensembles against the JAX package's: the trainers
(from a baseline, from scratch, SWAG; segmentation, ImSpec and custom
tasks), ``EnsemblePredictor``, ``ensemble_locate`` and ``load_ensemble``.

Weights cross over by ``unet_from_jax``, ``signal_ed_from_jax`` and
``ensemble_from_jax``; the JAX trainer runs its "vmap" member layout on the
CPU, the port its "map" loop. Tolerances, float32 on the CPU:
- training from a baseline: train losses 1e-3 relative; every member's
  parameters, running means and the averaged final parameters within
  2 * lr * steps (a near-zero gradient, such as a conv bias's before a
  BatchNorm, rounds differently in the two packages and Adam moves it by
  about lr a step either way); running variances 1e-2 relative (flax
  updates them with the biased batch variance, torch with the unbiased
  one: (1 - 0.9^3) / (n - 1) = 4.3e-3 at the Unet's bottleneck, n = 4 x 4
  x 4, plus the weights' drift);
- predictor means and variances: 1e-5 absolute;
- ``ensemble_locate``: equal cluster counts, cluster means 1e-4 px.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from atomai_tpu.nets.ed import init_imspec_model as jax_init_imspec_model
from atomai_tpu.nets.fcnn import Unet as JaxUnet
from atomai_tpu.predictors import EnsemblePredictor as JaxEnsemblePredictor
from atomai_tpu.predictors import ensemble_locate as jax_ensemble_locate
from atomai_tpu.trainers import EnsembleTrainer as JaxEnsembleTrainer
from atomai_tpu.trainers.trainer import _shuffled_batch_schedule
from atomai_tpu_torch.core.prng import generator_from_seed
from atomai_tpu_torch.models import (ensemble_from_jax, load_ensemble,
                                     signal_ed_from_jax, unet_from_jax)
from atomai_tpu_torch.nets import Unet, init_imspec_model
from atomai_tpu_torch.predictors import EnsemblePredictor, ensemble_locate
from atomai_tpu_torch.trainers import EnsembleTrainer
from atomai_tpu_torch.utils import (average_weights, make_lattice_stack,
                                    sample_weights)

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

RTOL_LOSS = 1e-3
TOL_PREDICT = 1e-5
TOL_PX = 1e-4
SIGNAL = dict(nblayers_encoder=2, nblayers_decoder=2, nbfilters_encoder=4,
              nbfilters_decoder=4)


@pytest.fixture(scope="module")
def script():
    return chip_smoke.fixture_script()


@pytest.fixture(scope="module")
def stored(script):
    return dict(np.load(script.ENSEMBLE_FIXTURE))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _assert_state_close(got, want, what):
    """chip_smoke.py's bounds: 2 * lr * steps, running variances 1e-2
    relative."""
    errs, tols = {}, {}
    chip_smoke.state_errors(got, want, chip_smoke.TOL_ENS_ADAM, errs, tols)
    assert not chip_smoke.failures(errs, tols), what


def _port_from_baseline(script, stored, swa, tmp):
    E = script.ENSEMBLE
    et = EnsembleTrainer("Unet", 1, nb_filters=E["nb_filters"],
                         layers=E["layers"], device="cpu")
    bp = script.unflatten(stored, "base")
    et.compile_ensemble_trainer(batch_size=E["batch"], swa=swa,
                                filename=os.path.join(tmp, "ens"))
    net, ens = et.train_ensemble_from_baseline(
        stored["x_train"], stored["y_train"], stored["x_test"],
        stored["y_test"], basemodel=unet_from_jax(
            bp, chip_smoke.identity_stats(bp)),
        n_models=E["n_models"], training_cycles_ensemble=E["cycles"])
    return et, net, ens


def test_ensemble_fixture_is_current(script, stored):
    fresh = script.make_ensemble_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith("member/") or k.endswith("_loss"):
            # XLA:CPU's float32 convs on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    assert sum(v.nbytes for v in stored.values()) < 1 << 20


@pytest.mark.parametrize("swa", [False, True], ids=["plain", "swa"])
def test_from_baseline_matches_jax(script, stored, swa, tmp_path):
    """Per-member schedules, losses, members (with their own BatchNorm
    statistics) and the members' mean as the final weights."""
    E = script.ENSEMBLE
    if swa:
        _, jet = script.run_jax_ensemble_from_baseline(swa=True)
        members = _np(jet.ensemble_state_dict)
        losses = np.asarray(jet.loss_acc["train_loss"])
    else:
        members = script.unflatten(stored, "member")
        losses = stored["train_loss"]
    et, net, ens = _port_from_baseline(script, stored, swa, str(tmp_path))
    np.testing.assert_array_equal(et.member_schedules, stored["schedules"])
    np.testing.assert_allclose(et.loss_acc["train_loss"], losses,
                               rtol=RTOL_LOSS)
    want = ensemble_from_jax(members, et.meta_state_dict)
    assert sorted(ens) == sorted(want) == list(range(E["n_models"]))
    for i in want:
        _assert_state_close(ens[i], want[i], f"member {i}")
    assert not torch.equal(ens[0]["bn.block.2.running_var"],
                           ens[1]["bn.block.2.running_var"])
    mean = {k: sum(want[i][k] for i in want) / len(want)
            for k, _ in net.named_parameters()}
    _assert_state_close(dict(net.named_parameters()), mean, "final")
    avg = average_weights(ens)
    for k, p in net.named_parameters():
        torch.testing.assert_close(avg[k], p.detach(), rtol=0, atol=1e-7)
    assert os.path.exists(str(tmp_path / "ens_ensemble_metadict.aoit"))


def test_chip_smoke_fixture_check_passes_on_the_cpu(tmp_path):
    """chip_smoke.py's check of the card against the fixture, run here."""
    errs, tols = chip_smoke.ensemble_fixture_run(torch.device("cpu"),
                                                 str(tmp_path))
    assert len(errs) > 50
    assert not chip_smoke.failures(errs, tols)


def _seg_data():
    imgs, masks, _ = make_lattice_stack(n_images=12, size=32, spacing=8,
                                        seed=2)
    return imgs[:10], masks[:10], imgs[10:], masks[10:]


def _seg_trainer(**kw):
    return EnsembleTrainer("Unet", 1, nb_filters=4, layers=(1, 1, 1, 1),
                           device="cpu", **kw)


def test_from_scratch_members_schedules_and_load_ensemble(tmp_path):
    x, y, xt, yt = _seg_data()
    runs = []
    for _ in range(2):
        et = _seg_trainer(seed=3)
        et.compile_ensemble_trainer(batch_size=4, training_cycles=5,
                                    filename=str(tmp_path / "scratch"))
        runs.append((et,) + et.train_ensemble_from_scratch(
            x, y, xt, yt, n_models=3))
    et, net, ens = runs[0]
    np.testing.assert_array_equal(et.member_schedules, np.stack(
        [_shuffled_batch_schedule(2, 5, i) for i in range(3)]))
    assert len(et.loss_acc["train_loss"]) == 5
    for k in ("c1.block.0.weight", "c1.block.2.running_mean"):
        assert not torch.equal(ens[0][k], ens[1][k])
        assert not torch.equal(ens[1][k], ens[2][k])
    for k, v in net.state_dict().items():
        assert torch.equal(v, ens[2][k]), k
    for i in ens:       # the same seed, the same members
        for k, v in ens[i].items():
            assert torch.equal(v, runs[1][2][i][k]), (i, k)

    net2, ens2 = load_ensemble(str(tmp_path / "scratch_ensemble_metadict"
                                            ".aoit"), device="cpu")
    assert type(net2) is Unet and sorted(ens2) == [0, 1, 2]
    for i in ens:
        for k, v in ens[i].items():
            assert torch.equal(v, ens2[i][k]), (i, k)
    kw = dict(nb_classes=1, verbose=0)
    a = EnsemblePredictor(net, ens, **kw).predict(xt)
    b = EnsemblePredictor(net2, ens2, **kw).predict(xt)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_swag_samples_share_batch_stats_and_follow_the_moments(tmp_path):
    x, y, xt, yt = _seg_data()
    et = _seg_trainer()
    et.compile_ensemble_trainer(batch_size=4, training_cycles=6,
                                filename=str(tmp_path / "swag"))
    net, ens = et.train_swag(x, y, xt, yt, n_models=3)
    base = net.state_dict()
    assert sorted(ens) == [0, 1, 2]
    for i in ens:
        assert ens[i].keys() == base.keys()
        for k, v in base.items():
            assert ens[i][k].shape == v.shape
            if "running" in k:
                assert torch.equal(ens[i][k], v), (i, k)
    assert not torch.equal(ens[0]["c1.block.0.weight"],
                           ens[1]["c1.block.0.weight"])
    mean, var = et.running_weights_stats
    assert any(float(v.max()) > 0 for v in var.values())
    # the draws' moments, element by element, within 6 standard errors
    # (about 2e4 elements: a false alarm has odds of about 4e-5)
    n = 4000
    draws = sample_weights(mean, var, generator_from_seed(0), n)
    for k in mean:
        s = torch.stack([d[k] for d in draws]).double()
        m, v = mean[k].double(), var[k].double()
        assert float(((s.mean(0) - m).abs() - 6 * (v / n).sqrt())
                     .max()) <= 1e-7, k
        assert float(((s.var(0) - v).abs() - 6 * (2 / n) ** 0.5 * v)
                     .max()) <= 1e-12, k


def test_layouts_meshes_and_remat():
    et = _seg_trainer()
    with pytest.raises(NotImplementedError, match="Queue 1 #23"):
        et.compile_ensemble_trainer(member_layout="vmap")
    with pytest.raises(ValueError, match="member_layout"):
        et.compile_ensemble_trainer(member_layout="pmap")
    et.compile_ensemble_trainer(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        et._resolve_mesh(4)
    # remat is taken (members train on checkpointed blocks: exactness in
    # test_torch_remat.py)
    et.compile_ensemble_trainer(remat=True)
    assert et.kdict["remat"] is True
    et.compile_ensemble_trainer(member_layout="map", mesh=False)
    with pytest.raises(AssertionError, match="latent"):
        EnsembleTrainer("imspec", in_dim=(8, 8), out_dim=(8,), device="cpu")


def _imspec_data(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 16, 16).astype(np.float32),
            rng.rand(n, 16).astype(np.float32))


def test_imspec_task_from_baseline_matches_jax(tmp_path):
    """The ImSpec task: staged pairs, the members from a SignalED baseline,
    against the JAX trainer; then the saved ensemble reloads with the
    metadict's dims and widths."""
    X, y = _imspec_data()
    dims = dict(in_dim=(16, 16), out_dim=(16,), latent_dim=2)
    jet = JaxEnsembleTrainer("imspec", **dims, **SIGNAL)
    v = _np(jax.jit(lambda k, x0: dict(jet.net.init(
        {"params": k}, x0, False)))(jax.random.key(4), jnp.asarray(X[:1])))
    jet.params, jet.batch_stats = v["params"], v["batch_stats"]
    fit = dict(batch_size=4, loss="mse")
    jet.compile_ensemble_trainer(mesh=False, member_layout="vmap",
                                 filename=str(tmp_path / "jax"), **fit)
    with jax.default_matmul_precision("highest"):
        jet.train_ensemble_from_baseline(
            X[:8], y[:8], X[8:], y[8:], basemodel=v["params"], n_models=2,
            training_cycles_ensemble=3)
    et = EnsembleTrainer("imspec", device="cpu", **dims, **SIGNAL)
    et.compile_ensemble_trainer(filename=str(tmp_path / "port"), **fit)
    base = signal_ed_from_jax(v["params"], v["batch_stats"],
                              et.meta_state_dict)
    net, ens = et.train_ensemble_from_baseline(
        X[:8], y[:8], X[8:], y[8:], basemodel=base, n_models=2,
        training_cycles_ensemble=3)
    np.testing.assert_allclose(et.loss_acc["train_loss"],
                               jet.loss_acc["train_loss"], rtol=RTOL_LOSS)
    want = ensemble_from_jax(_np(jet.ensemble_state_dict),
                             et.meta_state_dict)
    for i in want:
        _assert_state_close(ens[i], want[i], f"member {i}")

    net2, ens2 = load_ensemble(str(tmp_path / "port_ensemble_metadict.aoit"),
                               device="cpu")
    assert net2.encoder.fc.in_features == net.encoder.fc.in_features
    kw = dict(data_type="image", output_type="spectra", in_dim=(16, 16),
              out_dim=(16,), verbose=0)
    a = EnsemblePredictor(net, ens, **kw).predict(X)
    b = EnsemblePredictor(net2, ens2, **kw).predict(X)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u, w)


def test_custom_module_task(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.rand(24, 6).astype(np.float32)
    y = (X @ rng.rand(6, 2)).astype(np.float32)
    model = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 2))
    et = EnsembleTrainer(model, device="cpu")
    et.compile_ensemble_trainer(batch_size=6, training_cycles=4, loss="mse",
                                filename=str(tmp_path / "custom"))
    net, ens = et.train_ensemble_from_scratch(X[:18], y[:18], X[18:], y[18:],
                                              n_models=2)
    assert et._task == "custom" and sorted(ens) == [0, 1]
    assert not torch.equal(ens[0]["0.weight"], ens[1]["0.weight"])
    assert np.isfinite(et.loss_acc["train_loss"]).all()


# ------------------------------------------------------------ predictor
def _jax_members(net, x0, n, seed, stats_seed):
    """n JAX members, each with its own (random) BatchNorm statistics."""
    init = jax.jit(lambda k: dict(net.init({"params": k}, x0, False)))
    rng = np.random.RandomState(stats_seed)
    out = {}
    for i in range(n):
        v = _np(init(jax.random.key(seed + i)))
        out[i] = {"params": v["params"], "batch_stats": jax.tree.map(
            lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"])}
    return out


def _predict_pair(jnet, tnet, members, meta, x, num_batches, keys=None,
                  **kw):
    keys = keys or list(members)
    jens = {k: members[i] for k, i in zip(keys, members)}
    want = JaxEnsemblePredictor(jnet, jens, mesh=False, verbose=0,
                                **kw).predict(x, num_batches=num_batches)
    tens = {k: v for k, v in zip(keys, ensemble_from_jax(
        members, meta).values())}
    got = {layout: EnsemblePredictor(tnet, tens, member_layout=layout,
                                     verbose=0, **kw).predict(
        x, num_batches=num_batches) for layout in ("map", "vmap")}
    return want, got


def _assert_predictions(want, got):
    for layout, pair in got.items():
        for g, w, what in zip(pair, want, ("mean", "var")):
            assert g.shape == w.shape, (layout, what, g.shape, w.shape)
            np.testing.assert_allclose(g, w, atol=TOL_PREDICT, rtol=0,
                                       err_msg=f"{layout} {what}")
    for g, w in zip(got["map"], got["vmap"]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("keys", ["int", "digit_strings"])
def test_predictor_image_to_image_matches_jax(keys):
    """11 Unet members (digit-string keys "0".."10" must run in numeric
    order, each with its own statistics), 7 frames in 3 chunks and a
    remainder."""
    jnet = JaxUnet(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1))
    members = _jax_members(jnet, jnp.zeros((1, 16, 16, 1)), 11, 10, 0)
    x = np.random.RandomState(1).rand(7, 16, 16).astype(np.float32) * 3
    names = [str(i) for i in range(11)] if keys == "digit_strings" else None
    tnet = Unet(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1))
    want, got = _predict_pair(jnet, tnet, members, {"model_type": "seg"}, x,
                              3, keys=names, nb_classes=1)
    assert want[0].shape == (7, 16, 16, 1)
    _assert_predictions(want, got)


@pytest.mark.parametrize("direction", ["image_spectra", "spectra_spectra",
                                       "spectra_image"])
def test_predictor_signal_ed_matches_jax(direction):
    # spectra -> spectra: the output takes the input's length (the JAX
    # package's shape rule), so both are 16
    in_dim, out_dim = {"image_spectra": ((16, 16), (12,)),
                       "spectra_spectra": ((16,), (16,)),
                       "spectra_image": ((16,), (8, 8))}[direction]
    kw = dict(SIGNAL, decoder_upsampling=direction == "spectra_image")
    jnet, _ = jax_init_imspec_model(in_dim, out_dim, 3, **kw)
    tnet, meta = init_imspec_model(in_dim, out_dim, 3, **kw)
    members = _jax_members(jnet, jnp.zeros((1,) + in_dim), 3, 20, 1)
    x = np.random.RandomState(2).rand(5, *in_dim).astype(np.float32)
    data_type, output_type = direction.split("_")
    want, got = _predict_pair(
        jnet, tnet, members, meta, x, 2, data_type=data_type,
        output_type=output_type, in_dim=in_dim, out_dim=out_dim)
    _assert_predictions(want, got)


def test_predictor_shapes_and_checks():
    tnet = Unet(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1))
    ens = {0: tnet.state_dict()}
    with pytest.raises(TypeError, match="in_dim"):
        EnsemblePredictor(tnet, ens, data_type="image",
                          output_type="spectra")
    with pytest.raises(TypeError, match="output types"):
        EnsemblePredictor(tnet, ens, output_type="volume")
    p = EnsemblePredictor(tnet, ens, nb_classes=1, verbose=0)
    x = np.random.RandomState(3).rand(3, 16, 16)
    mean, var = p.predict(x, format_out="channel_first")
    assert mean.shape == var.shape == (3, 1, 16, 16)
    assert float(np.abs(var).max()) == 0.0       # one member
    with pytest.raises(ValueError, match="channel"):
        p.predict(x, format_out="nhwc")


# --------------------------------------------------------------- locate
def _member_maps(n_models=3, n_images=2, seed=0):
    """Each member's maps: the lattice masks, each blob shifted by one
    pixel in some members, some blobs missed, some noise."""
    _, masks, _ = make_lattice_stack(n_images=n_images, size=64, spacing=12,
                                     seed=seed)
    rng = np.random.RandomState(seed)
    maps = []
    for m in range(n_models):
        shifted = np.roll(masks, m % 2, axis=1 + m % 2).astype(np.float32)
        shifted *= rng.rand(*shifted.shape) > 0.02
        maps.append(shifted * 0.9 + 0.05 * rng.rand(*shifted.shape))
    return np.stack(maps)[..., None].astype(np.float32)


def _sorted_rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


@pytest.mark.parametrize("min_samples", [2, 3])
def test_ensemble_locate_matches_jax(min_samples):
    maps = _member_maps()
    kw = dict(eps=1.5, min_samples=min_samples)
    got_mean, got_var = ensemble_locate(maps, device="cpu", **kw)
    want_mean, want_var = jax_ensemble_locate(maps, **kw)
    assert sorted(got_mean) == sorted(want_mean) == [0, 1]
    for i in want_mean:
        assert len(got_mean[i]) == len(want_mean[i]) > 5
        np.testing.assert_allclose(_sorted_rows(got_mean[i]),
                                   _sorted_rows(want_mean[i]), atol=TOL_PX)
        np.testing.assert_allclose(np.sort(got_var[i], 0),
                                   np.sort(want_var[i], 0), atol=TOL_PX)
    # a tensor stays on its device and gives the same
    t_mean, _ = ensemble_locate(torch.from_numpy(maps), **kw)
    for i in got_mean:
        np.testing.assert_array_equal(t_mean[i], got_mean[i])


def test_ensemble_locate_empty():
    maps = np.zeros((2, 3, 24, 24, 1), np.float32)
    mean, var = ensemble_locate(maps, eps=1.0, min_samples=2, device="cpu")
    jmean, _ = jax_ensemble_locate(maps, eps=1.0, min_samples=2)
    assert sorted(mean) == sorted(jmean) == [0, 1, 2]
    for i in mean:
        assert mean[i].shape == var[i].shape == jmean[i].shape == (0, 2)
