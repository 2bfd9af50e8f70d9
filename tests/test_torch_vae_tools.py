"""The VAE family's tools in the port against the JAX package's: the
Gumbel-softmax draw and the log-pdfs, ``encode`` with the discrete
latents, ``manifold2d`` at each discrete category, ``manifold_traversal``,
``encode_images`` and ``encode_trajectories`` of models that carry the
same weights; the image and coordinate helpers they stand on
(``extract_subimages``, ``crop_borders``, ``get_coord_grid``,
``chain_tracks``, ``subimg_trajectories``) and the native k-NN (equal to
its cKDTree version and to the JAX package's). Then the port's own
contracts: ``fit(epochs_per_dispatch=n)`` gives the per-epoch history,
joint models round-trip through ``load_model``, the conv decoder's output
conv keeps flax's default init, and ``savefig`` / ``recording`` write
their files.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import atomai_tpu as jaoi
from atomai_tpu.native import neighbors as jneighbors
from atomai_tpu.trainers.vitrainer import viBaseTrainer as jTrainer
from atomai_tpu.utils import coords as jcoords
from atomai_tpu.utils import img as jimg
import atomai_tpu_torch as aoi
from atomai_tpu_torch import native
from atomai_tpu_torch.nets import init_VAE_nets, init_weights_
from atomai_tpu_torch.core.prng import generator_from_seed
from atomai_tpu_torch.trainers.vitrainer import viBaseTrainer
from atomai_tpu_torch.utils import coords, img

torch.set_num_threads(1)

TOL = 1e-5
WINDOW = 8


def _pair(cls, **kwargs):
    jm = getattr(jaoi.models, cls)((WINDOW, WINDOW), seed=0, **kwargs)
    jm._init_params()
    tm = getattr(aoi.models, cls)((WINDOW, WINDOW), seed=0, device="cpu",
                                  **kwargs)
    tm.load_jax_params(jax.tree.map(np.asarray, jax.device_get(jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def jvae_pair():
    return _pair("jVAE", discrete_dim=[3, 2], numhidden_encoder=16,
                 numhidden_decoder=16)


@pytest.fixture(scope="module")
def jrvae_pair():
    return _pair("jrVAE", discrete_dim=[3], numhidden_encoder=16,
                 numhidden_decoder=16)


@pytest.fixture(scope="module")
def stack():
    """Four 48 x 48 lattice frames, the atoms moving one pixel to the
    right a frame: (frames, {frame: (n, 3) [row, col, 0]})."""
    imgs, _, xy = aoi.utils.make_lattice_stack(n_images=1, size=48,
                                               spacing=8, seed=2)
    frames = np.stack([np.roll(imgs[0], t, axis=1) for t in range(4)])
    cdict = {t: np.concatenate([xy[0] + [0, t], np.zeros((len(xy[0]), 1))],
                               -1) for t in range(4)}
    return frames, cdict


def test_reparameterize_discrete_matches_jax():
    rng = np.random.RandomState(0)
    alpha = rng.rand(7, 5).astype(np.float32)
    alpha /= alpha.sum(1, keepdims=True)
    u = rng.rand(7, 5).astype(np.float32)
    u[0, 0], u[1, 1] = 0.0, 1.0 - 2 ** -24     # the eps keeps both finite
    for tau in (0.67, 0.1, 2.0):
        with mock.patch.object(jax.random, "uniform",
                               lambda *a, **k: jnp.asarray(u)):
            want = np.asarray(jTrainer.reparameterize_discrete(
                jax.random.key(0), jnp.asarray(alpha), tau))
        got = viBaseTrainer.reparameterize_discrete(
            torch.from_numpy(alpha), tau, u=torch.from_numpy(u)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    g = generator_from_seed(3)
    a = viBaseTrainer.reparameterize_discrete(torch.from_numpy(alpha), 0.67,
                                              generator=g)
    b = viBaseTrainer.reparameterize_discrete(
        torch.from_numpy(alpha), 0.67,
        u=torch.rand(alpha.shape, generator=generator_from_seed(3)))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.sum(1).numpy(), 1, rtol=1e-6)


def test_log_pdfs_match_jax():
    rng = np.random.RandomState(1)
    x, mu = rng.randn(2, 6, 4).astype(np.float32)
    lsd = (0.3 * rng.randn(6, 4)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, mu, lsd)]
    np.testing.assert_allclose(viBaseTrainer.log_normal(*t).numpy(),
                               np.asarray(jTrainer.log_normal(x, mu, lsd)),
                               rtol=TOL)
    np.testing.assert_allclose(viBaseTrainer.log_unit_normal(t[0]).numpy(),
                               np.asarray(jTrainer.log_unit_normal(x)),
                               rtol=TOL)


@pytest.mark.parametrize("which", ["jvae", "jrvae"])
def test_encode_manifold_and_traversal_match_jax(which, jvae_pair,
                                                 jrvae_pair):
    jm, tm = jvae_pair if which == "jvae" else jrvae_pair
    x = np.random.RandomState(2).rand(9, WINDOW, WINDOW).astype(np.float32)
    want = jm.encode(x, num_batches=2)
    got = tm.encode(x, num_batches=2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-6)
    for idx in range(sum(tm.discrete_dim)):
        np.testing.assert_allclose(tm.manifold2d(d=3, disc_idx=idx),
                                   jm.manifold2d(d=3, disc_idx=idx),
                                   rtol=TOL, atol=1e-6)
    if len(tm.discrete_dim) > 1:
        return      # the traversal sweeps a model's only discrete latent
    for kw in ({}, {"keep_square": True, "pad": 1}):
        want = jm.manifold_traversal(0, d=4, **kw)
        got = tm.manifold_traversal(0, d=4, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(
        aoi.models.make_grid(np.arange(60.).reshape(5, 1, 3, 4), nrow=2),
        jaoi.models.dgm.vae.make_grid(np.arange(60.).reshape(5, 1, 3, 4),
                                      nrow=2))


def test_encode_images_matches_jax(jvae_pair):
    jm, tm = jvae_pair
    frame = aoi.utils.make_lattice_stack(n_images=1, size=24, spacing=8,
                                         seed=4)[0]
    frame = frame - frame.min() + 0.01     # no zero border to crop
    want_img, want_z = jm.encode_images(frame, num_batches=4)
    got_img, got_z = tm.encode_images(frame, num_batches=4)
    assert got_z.shape == want_z.shape == (1, 17, 17, 2)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_allclose(got_z, want_z, rtol=TOL, atol=1e-6)


def test_encode_trajectories_matches_jax(jvae_pair, stack):
    jm, tm = jvae_pair
    frames, cdict = stack
    want = jm.encode_trajectories(frames, cdict, WINDOW, 2, 3,
                                  num_batches=2)
    got = tm.encode_trajectories(frames, cdict, WINDOW, 2, 3, num_batches=2)
    assert len(got[0]) == len(want[0]) > 5
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=1e-6)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


def test_subimg_trajectories_and_chain_tracks_match_jax(stack):
    frames, cdict = stack
    # a dropped atom and a far outlier: held positions and a resumed track
    cdict = dict(cdict)
    cdict[2] = np.concatenate([cdict[2][1:], [[100.0, 100.0, 0.0]]])
    want = jcoords.subimg_trajectories(frames, cdict, WINDOW, 0,
                                       3).get_all_trajectories()
    got = coords.subimg_trajectories(frames, cdict, WINDOW, 0,
                                     3).get_all_trajectories()
    for part_g, part_w in zip(got, want):
        assert len(part_g) == len(part_w)
        for g, w in zip(part_g, part_w):
            np.testing.assert_array_equal(g, w)
    starts = cdict[0][:, :2] + 0.4
    want = jcoords.chain_tracks(cdict, starts, 2.5)
    got = coords.chain_tracks(cdict, starts, 2.5)
    assert any(len(f) < 4 for f, _ in got)
    for (gf, gr), (wf, wr) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gr, wr)
    one = coords.subimg_trajectories(frames, cdict, WINDOW, 0,
                                     3).get_trajectory(cdict[0][5, :2])
    jone = jcoords.subimg_trajectories(frames, cdict, WINDOW, 0,
                                       3).get_trajectory(cdict[0][5, :2])
    for g, w in zip(one, jone):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_helpers_match_jax(seed):
    rng = np.random.RandomState(seed)
    stack_ = rng.rand(3, 20, 18).astype(np.float32)
    stack_[1, 5, 6] = np.nan
    cdict = {i: np.concatenate([rng.uniform(-2, 22, (12, 2)),
                                rng.randint(0, 2, (12, 1))], -1)
             for i in range(4)}
    for cls in (0, 1):
        for g, w in zip(img.extract_subimages(stack_, cdict, 5, cls),
                        jimg.extract_subimages(stack_, cdict, 5, cls)):
            np.testing.assert_array_equal(g, w)
    xy = rng.uniform(0, 20, (9, 2))
    for g, w in zip(img.extract_subimages(stack_[0], xy, 4),
                    jimg.extract_subimages(stack_[0], xy, 4)):
        np.testing.assert_array_equal(g, w)
    far = {0: np.array([[50.0, 50.0, 0.0]])}
    for g, w in zip(img.extract_subimages(stack_, far, 5),
                    jimg.extract_subimages(stack_, far, 5)):
        assert g.shape == w.shape and len(g) == 0
    for arr in (stack_[0], stack_):
        for step in (1, 3):
            np.testing.assert_array_equal(
                img.get_coord_grid(arr, step, return_dict=False),
                jimg.get_coord_grid(arr, step, return_dict=False))
            got = img.get_coord_grid(arr, step)
            want = jimg.get_coord_grid(arr, step)
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    padded = np.zeros((14, 15, 2), np.float32)
    padded[3:9, 2:12] = rng.rand(6, 10, 2) + 0.1
    np.testing.assert_array_equal(img.crop_borders(padded, 0),
                                  jimg.crop_borders(padded, 0))
    np.testing.assert_array_equal(img.crop_borders(padded, 0.5),
                                  jimg.crop_borders(padded, 0.5))


@pytest.mark.parametrize("dim,ub", [(2, None), (2, 1.5), (3, 2.0),
                                    (2, 0.0)])
def test_knn_native_equals_reference_and_jax(dim, ub):
    rng = np.random.RandomState(dim)
    pts = rng.rand(300, dim) * 20
    q = np.concatenate([rng.rand(40, dim) * 20, pts[:5],
                        rng.rand(3, dim) * 20 + 100])
    for k in (1, 4):
        d, i = native.knn(pts, q, k, ub)
        d_ref, i_ref = native.knn_reference(pts, q, k, ub)
        d_jax, i_jax = jneighbors.knn(pts, q, k, ub)
        assert d.dtype == np.float64 and i.dtype == np.int64
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_array_equal(i, i_jax)
        np.testing.assert_allclose(d, d_ref, rtol=1e-12)
        np.testing.assert_array_equal(d, d_jax)
        assert (i[np.isinf(d)] == len(pts)).all()
    empty = native.knn(np.empty((0, 2)), q[:, :2], 2)
    assert np.isinf(empty[0]).all() and (empty[1] == 0).all()


def _patches(n=32, size=WINDOW):
    imgs, _, _ = aoi.utils.make_lattice_stack(n_images=2, size=40,
                                              spacing=8, seed=5)
    return np.concatenate([aoi.utils.extract_patches_2d(
        p, (size, size), n // 2, i) for i, p in enumerate(imgs)])


def test_epochs_per_dispatch_gives_the_per_epoch_history(tmp_path, capsys):
    X = _patches()
    runs = []
    for epd in (1, 3, 7):
        m = aoi.models.jrVAE((WINDOW, WINDOW), discrete_dim=[2], seed=4,
                             numhidden_encoder=16, numhidden_decoder=16,
                             device="cpu")
        log = str(tmp_path / f"run{epd}.jsonl")
        capsys.readouterr()
        m.fit(X[:24], X_test=X[24:], training_cycles=5, batch_size=8,
              epochs_per_dispatch=epd, filename=str(tmp_path / f"m{epd}"),
              metrics_log=log)
        lines = [json.loads(s) for s in open(log)]
        assert [r["cycle"] for r in lines] == list(range(5))
        runs.append((m.loss_history, m.num_iter, m.metadict["num_epochs"],
                     [(r["train_elbo"], r["test_elbo"]) for r in lines],
                     capsys.readouterr().out))
    for hist, num_iter, epochs, logged, printed in runs:
        assert hist == runs[0][0] and len(hist["test_loss"]) == 5
        assert num_iter == runs[0][1] == 5 * 3 and epochs == 4
        np.testing.assert_allclose(
            logged, list(zip(hist["train_loss"], hist["test_loss"])))
        assert printed == runs[0][4]
    assert runs[0][4].splitlines()[-1] == (
        "Epoch: 5/5, Training loss: {:.4f}, Test loss: {:.4f}".format(
            -hist["train_loss"][-1], -hist["test_loss"][-1]))


@pytest.mark.parametrize("cls,kwargs", [
    ("jVAE", dict(discrete_dim=[3, 2], conv_encoder=True,
                  conv_decoder=True)),
    ("jrVAE", dict(discrete_dim=[2], translation=False, nb_classes=2))])
def test_load_model_round_trips_joint_models(cls, kwargs, tmp_path):
    X = _patches()
    y = np.arange(len(X)) % 2
    m = getattr(aoi.models, cls)((WINDOW, WINDOW), numhidden_encoder=8,
                                 numhidden_decoder=16, device="cpu",
                                 **kwargs)
    m.fit(X, y if kwargs.get("nb_classes") else None, training_cycles=2,
          batch_size=16, filename=str(tmp_path / "m"), verbose=False)
    m2 = aoi.load_model(str(tmp_path / "m.aoit"), device="cpu")
    assert type(m2) is type(m) and m2.discrete_dim == m.discrete_dim
    assert m2.num_iter == m.num_iter == 4 and m2.coord == m.coord
    for a, b in zip(m2.encode(X[:5]), m.encode(X[:5])):
        np.testing.assert_array_equal(a, b)
    z = np.random.RandomState(0).randn(3, m.z_dim - m.coord)
    np.testing.assert_array_equal(m2.decode(z, 1 if m.nb_classes else None),
                                  m.decode(z, 1 if m.nb_classes else None))
    assert type(aoi.models.load_vae_model(str(tmp_path / "m.aoit"),
                                          device="cpu")) is type(m)


def test_conv_decoder_output_conv_keeps_flax_default_init():
    """The 1x1 output conv: lecun-normal (a normal of std sqrt(1/fan_in)
    truncated at two std, rescaled to that variance), zero bias, as
    flax's default; every other layer U(+-1/sqrt(fan_in))."""
    from scipy import stats
    _, dec, _ = init_VAE_nets((8, 8, 32), 2, conv_decoder=True,
                              numhidden_decoder=64)
    init_weights_(dec, generator_from_seed(0))
    w = dec.out.weight.detach().numpy().ravel()
    assert dec.out.weight.shape == (32, 64, 1, 1) and w.size == 2048
    assert not dec.out.bias.detach().any()
    std = 64 ** -0.5 / .87962566103423978
    assert np.abs(w).max() <= 2 * std
    assert stats.kstest(w / std, stats.truncnorm(-2, 2).cdf).pvalue > 1e-3
    assert stats.kstest(w * 8, stats.uniform(-1, 2).cdf).pvalue < 1e-6
    np.testing.assert_allclose(w.std(), 64 ** -0.5, rtol=0.1)
    for m in dec.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) \
                and m is not dec.out:
            fan_in = m.weight[0].numel()
            assert float(m.weight.detach().abs().max()) <= fan_in ** -0.5
    # the JAX package's output conv draws from the same law
    jm = jaoi.models.VAE((8, 8, 32), conv_decoder=True, numhidden_decoder=64)
    jm._init_params()
    jw = np.asarray(jm.params["decoder"]["Conv_0"]["kernel"]).ravel()
    assert stats.ks_2samp(w, jw).pvalue > 1e-3
    assert not np.asarray(jm.params["decoder"]["Conv_0"]["bias"]).any()


def test_savefig_and_recording_write_their_files(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    monkeypatch.chdir(tmp_path)
    X = _patches(16)
    m = aoi.models.rVAE((WINDOW, WINDOW), numhidden_encoder=8,
                        numhidden_decoder=16, device="cpu")
    fig = m.manifold2d(d=2, savefig=True, savedir=str(tmp_path / "figs"),
                       filename="mf")
    assert fig.shape == (16, 16)
    assert os.path.getsize(tmp_path / "figs" / "mf.png") > 0
    m.fit(X, training_cycles=2, batch_size=8, recording=True,
          epochs_per_dispatch=2, filename=str(tmp_path / "r"), verbose=False)
    assert m.z_dim == 5 and m.num_iter == 4
    assert sorted(os.listdir(tmp_path / "vae_learning")) == ["0.png",
                                                            "1.png"]
    from PIL import Image
    with Image.open(tmp_path / "manifold_learning.gif") as gif:
        assert gif.n_frames == 2
