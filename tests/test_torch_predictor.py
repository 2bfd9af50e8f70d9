"""The port's SegPredictor and Locator against the JAX package's, and the
two golden fixtures of ``tests/test_golden_fixtures.py`` through the port.

Maps: float32 on the CPU, atol 1e-5 (summation order). Coordinates: atol
1e-4 px (the JAX package's float32 moment sums); frames, counts and class
columns exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.nets import Unet as JaxUnet
from atomai_tpu.predictors import EnsemblePredictor as JaxEnsemblePredictor
from atomai_tpu.predictors import ImSpecPredictor as JaxImSpecPredictor
from atomai_tpu.predictors import Locator as JaxLocator
from atomai_tpu.predictors import RegPredictor as JaxRegPredictor
from atomai_tpu.predictors import SegPredictor as JaxSegPredictor
from atomai_tpu_torch.models import unet_from_jax
from atomai_tpu_torch.nets import Unet
from atomai_tpu_torch.predictors import (EnsemblePredictor, ImSpecPredictor,
                                         Locator, RegPredictor, SegPredictor)
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

ATOL_MAPS = 1e-5
TOL_PX = 1e-4
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def nets():
    """A small JAX Unet with non-trivial BatchNorm statistics and the port
    Unet carrying the same weights."""
    jnet = JaxUnet(nb_classes=1, nb_filters=4, layers=(1, 2, 2, 3))
    v = jax.device_get(jnet.init({"params": jax.random.key(2)},
                                 jnp.zeros((1, 16, 16, 1)), False))
    rng = np.random.RandomState(0)
    stats = jax.tree.map(
        lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
        dict(v["batch_stats"]))
    params = jax.tree.map(np.asarray, dict(v["params"]))
    net = Unet(nb_classes=1, nb_filters=4, layers=(1, 2, 2, 3))
    net.load_state_dict(unet_from_jax(params, stats))
    return jnet, params, stats, net.eval()


@pytest.mark.parametrize("size", [64, 60])
def test_seg_predictor_maps_match_jax(nets, size):
    jnet, params, stats, net = nets
    imgs = np.random.RandomState(size).rand(3, size, size).astype(
        np.float32) * 5 - 1  # not normalised: predict normalises the stack
    ref = JaxSegPredictor(jnet, params, stats, nb_classes=1,
                          verbose=False).predict(imgs)
    got = SegPredictor(net, nb_classes=1, verbose=False).predict(imgs)
    assert got.shape == ref.shape == (3, 64, 64, 1)  # padded to 8
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL_MAPS)


@pytest.mark.parametrize("size", [64, 60])
def test_predict_return_image_matches_jax(nets, size):
    """``return_image=True``: (preprocessed NHWC images, maps) as numpy,
    images first, in the JAX package's order and shapes."""
    jnet, params, stats, net = nets
    imgs = np.random.RandomState(size + 1).rand(3, size, size).astype(
        np.float32) * 3
    ref_x, ref_y = JaxSegPredictor(jnet, params, stats, nb_classes=1,
                                   verbose=False).predict(imgs,
                                                          return_image=True)
    got_x, got_y = SegPredictor(net, nb_classes=1, verbose=False).predict(
        imgs, return_image=True)
    assert isinstance(got_x, np.ndarray) and isinstance(got_y, np.ndarray)
    assert got_x.shape == ref_x.shape == (3, 64, 64, 1)
    assert got_y.shape == ref_y.shape == (3, 64, 64, 1)
    np.testing.assert_allclose(got_x, ref_x, atol=ATOL_MAPS)
    np.testing.assert_allclose(got_y, ref_y, atol=ATOL_MAPS)


def _preprocessors(nets, case):
    """(the port's preprocess, the JAX package's) of one predictor and
    data type; both return the predictor's model input."""
    jnet, params, stats, net = nets
    if case == "seg":
        return (SegPredictor(net, verbose=False).preprocess,
                JaxSegPredictor(jnet, params, stats, verbose=False)
                .preprocess)
    if case.startswith("ensemble"):
        kind = case.split("_")[1]
        member = {"params": params, "batch_stats": stats}
        return (EnsemblePredictor(net, {0: net.state_dict()},
                                  data_type=kind, output_type=kind,
                                  verbose=0).preprocess,
                JaxEnsemblePredictor(jnet, {0: member}, data_type=kind,
                                     output_type=kind).preprocess)
    if case.startswith("imspec"):
        dim = (8,) if case == "imspec_image" else (16, 16)
        return (ImSpecPredictor(net, dim, verbose=False).preprocess,
                JaxImSpecPredictor(jnet, params, dim, verbose=False)
                .preprocess)
    # the port's RegPredictor hands its net NCHW, the JAX package's NHWC
    port = RegPredictor(net, 1, verbose=False).preprocess
    return (lambda d: port(d).permute(0, 2, 3, 1),
            JaxRegPredictor(jnet, params, 1, verbose=False).preprocess)


@pytest.mark.parametrize("stack", ["varied", "constant"])
@pytest.mark.parametrize("case", ["seg", "ensemble_image",
                                  "ensemble_spectra", "imspec_image",
                                  "imspec_spectra", "reg"])
def test_preprocess_normalises_whole_stack(nets, case, stack):
    """Every predictor min-max normalises over the whole stack, on the
    tensor's device, into the JAX package's input bit for bit; a constant
    stack meets the 1e-12 floor and reads 0."""
    spectra = case.endswith("spectra")
    shape = (2, 16) if spectra else (2, 16, 16)
    data = np.ones(shape) * np.array([2.0, 4.0]).reshape(
        (2,) + (1,) * (len(shape) - 1))
    if stack == "varied":
        data[(0,) + (3,) * (len(shape) - 1)] = 0.0
    else:
        data[:] = 3.0
    port, jax_pre = _preprocessors(nets, case)
    x = port(data)
    ref = np.asarray(jax_pre(data))
    assert x.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(x.numpy(), ref)
    if stack == "varied":
        assert x.min() == 0 and x.max() == 1 and x[1].min() == 1
    else:
        assert not x.any()


def test_predict_with_resize_matches_jax(nets):
    jnet, params, stats, net = nets
    imgs = np.random.RandomState(1).rand(2, 50, 70).astype(np.float32)
    ref = JaxSegPredictor(jnet, params, stats, resize=(32, 40),
                          verbose=False).predict(imgs)
    got = SegPredictor(net, resize=(32, 40), verbose=False).predict(imgs)
    np.testing.assert_allclose(got, ref, atol=ATOL_MAPS)


def test_chunked_forward_equals_one_batch(nets):
    net = nets[3]
    imgs = np.random.RandomState(2).rand(5, 32, 32).astype(np.float32)
    pred = SegPredictor(net, verbose=False)
    one = pred.predict(imgs, num_batches=1)
    np.testing.assert_allclose(pred.predict(imgs, num_batches=2), one,
                               atol=1e-6)


def _assert_same_coords(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k][:, :2], ref[k][:, :2], atol=TOL_PX)
        np.testing.assert_array_equal(got[k][:, 2], ref[k][:, 2])


@pytest.mark.parametrize("n_images", [4, 10])  # JAX: per-frame / tiled path
def test_locator_matches_jax(n_images):
    _, masks, _ = make_lattice_stack(n_images=n_images, size=64, spacing=12,
                                     seed=3)
    nn_output = masks[..., None].astype(np.float32)
    _assert_same_coords(Locator(0.5, device="cpu").run(nn_output),
                        JaxLocator(0.5).run(nn_output))


@pytest.mark.parametrize("n_images", [3, 5])  # 6 and 10 masks
def test_locator_two_classes_matches_jax(n_images):
    _, a, _ = make_lattice_stack(n_images=n_images, size=48, spacing=10,
                                 seed=4)
    _, b, _ = make_lattice_stack(n_images=n_images, size=48, spacing=14,
                                 seed=5)
    b = b * (a == 0)
    nn_output = np.stack([a, b, 1 - np.maximum(a, b)], -1).astype(
        np.float32)
    got = Locator(0.5, device="cpu").run(nn_output)
    _assert_same_coords(got, JaxLocator(0.5).run(nn_output))
    assert set(np.unique(got[0][:, 2])) == {0.0, 1.0}


def test_locator_channel_first_and_tensor_input():
    _, masks, _ = make_lattice_stack(n_images=2, size=64, spacing=12, seed=6)
    nchw = np.stack([masks, 1 - masks], 1).astype(np.float32)
    ref = JaxLocator(0.5, dim_order="channel_first").run(nchw)
    got = Locator(0.5, dim_order="channel_first").run(torch.from_numpy(nchw))
    _assert_same_coords(got, ref)


def test_locator_numpy_input_goes_to_the_card():
    """A numpy input is labelled on ``device``, by default the card: with no
    card that raises instead of labelling on the CPU. A tensor input stays
    on its own device whatever ``device`` says (SegPredictor's route)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, masks, _ = make_lattice_stack(n_images=2, size=48, spacing=12, seed=8)
    nn_output = masks[..., None].astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Locator(0.5).run(nn_output)
    got = Locator(0.5).run(torch.from_numpy(nn_output))
    _assert_same_coords(got, Locator(0.5, device="cpu").run(nn_output))
    _assert_same_coords(got, JaxLocator(0.5).run(nn_output))


def test_locator_empty_frames():
    nn_output = np.zeros((3, 32, 32, 1), np.float32)
    got = Locator(0.5, device="cpu").run(nn_output)
    assert sorted(got) == [0, 1, 2]
    assert all(v.shape == (0, 3) for v in got.values())


def test_refine_is_not_ported_yet(nets):
    """Refinement is ported now (the name is kept): ``refine=True`` builds,
    the Locator asks for the images, and SegPredictor refines with the
    images it preprocessed (parity with JAX: test_torch_peakfit.py)."""
    imgs, masks, _ = make_lattice_stack(n_images=2, size=64, spacing=12,
                                        seed=6)
    with pytest.raises(AssertionError, match="Pass input image"):
        Locator(0.5, refine=True, d=4, device="cpu").run(masks[..., None])
    refined = Locator(0.5, refine=True, d=4, device="cpu").run(
        masks[..., None], imgs)
    plain = Locator(0.5, device="cpu").run(masks[..., None])
    for k in plain:
        assert refined[k].shape == plain[k].shape
        np.testing.assert_array_equal(refined[k][:, 2], plain[k][:, 2])
        assert np.abs(refined[k][:, :2] - plain[k][:, :2]).max() < 3
    maps, coords = SegPredictor(nets[3], refine=True, d=4,
                                verbose=False).run(imgs)
    assert maps.shape == (2, 64, 64, 1) and sorted(coords) == [0, 1]


@pytest.fixture(scope="module")
def golden_lattice():
    return make_lattice_stack(n_images=2, size=64, spacing=12, seed=7)


def test_golden_lattice_images(golden_lattice):
    expected = np.load(os.path.join(FIXDIR, "lattice_images.npy"))
    np.testing.assert_allclose(golden_lattice[0], expected, atol=1e-6)


def test_golden_locator_coordinates(golden_lattice):
    _, masks, _ = golden_lattice
    got = Locator(0.5, device="cpu").run(
        masks[..., None].astype(np.float32))[0]
    expected = np.load(os.path.join(FIXDIR, "locator_coords_frame0.npy"))
    assert got.shape == expected.shape
    a = got[np.lexsort(got[:, :2].T)]
    b = expected[np.lexsort(expected[:, :2].T)]
    np.testing.assert_allclose(a, b, atol=TOL_PX)
