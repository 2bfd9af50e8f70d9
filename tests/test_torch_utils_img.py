"""The port's image and coordinate utilities against the JAX package's:
resizing and rotation, windows and random crops, patches and spectra, the
FFT helpers and thresholds, blob filtering, contours and blob ellipses on
the labeller (its plain version here on the CPU; the JAX side runs its
XLA labelling loop), multiclass masks, ``find_com``, nearest-neighbour
distances, bond maps, coordinate clusters and comparisons. Every input is
drawn from a numpy seed.

Tolerances: windows, crops, patches, spectra, thresholds, filtered cells,
contours, masks, distances and clusters are exact; ``find_com`` within
one float32 ulp (the port divides exact int64 sums in float64 and rounds
once, the JAX package divides float32 sums); blob centres and angles
within 1e-9 (the port's central moments come from exact integer sums,
the JAX package's from float64 two-pass sums), angles modulo 180 degrees:
an angle is an axis' orientation, and where a blob's cross moment is
exactly 0 the JAX package's rounding can leave it a tiny negative
(-1.1e-17), which turns 180 into 0; resize and rotate within
1e-5 (float32 resampling, in other orders); the FFT helpers within 1e-6.
"""

import numpy as np
import pytest
import torch

from atomai_tpu.utils import coords as jcoords
from atomai_tpu.utils import img as jimg
from atomai_tpu.utils import imgen as jimgen
from atomai_tpu_torch.utils import coords, img, imgen, make_lattice_stack

torch.set_num_threads(1)

TOL_RESAMPLE = 1e-5
TOL_FFT = 1e-6
TOL_BLOB = 1e-9
CPU = dict(device="cpu")


def axis_diff(a, b):
    """Distance of two axis orientations in degrees (period 180)."""
    return np.abs((np.asarray(a) - np.asarray(b) + 90) % 180 - 90)


def blob_frames(n=3, size=96, seed=0):
    """(n, size, size) float32 maps: lattice atoms plus smoothed-noise
    blobs of every size and orientation, in [0, 1]."""
    from scipy import ndimage
    _, masks, _ = make_lattice_stack(n_images=n, size=size, spacing=12,
                                     seed=seed)
    rng = np.random.RandomState(seed)
    noise = ndimage.gaussian_filter(rng.rand(n, size, size), (0, 3, 3))
    noise = (noise - noise.min()) / (noise.max() - noise.min())
    return np.maximum(masks * 0.9, noise ** 3).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    return blob_frames()


# resizing and rotation ----------------------------------------------------

@pytest.mark.parametrize("shape,rs", [((40, 40), (64, 64)),
                                      ((64, 48), (32, 20)),
                                      ((40, 40, 3), (24, 56))])
def test_cv_resize_matches_jax(shape, rs):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got = img.cv_resize(x, rs)
    want = jimg.cv_resize(x, rs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL_RESAMPLE)
    assert np.array_equal(img.cv_resize(x, rs, round_=True),
                          np.round(got))
    assert np.array_equal(img.cv_resize(x, shape[:2]), x)


@pytest.mark.parametrize("rs", [16, (48, 40)])
def test_cv_resize_stack_matches_jax(rs):
    x = np.random.RandomState(2).rand(3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(img.cv_resize_stack(x, rs),
                               jimg.cv_resize_stack(x, rs),
                               atol=TOL_RESAMPLE)


@pytest.mark.parametrize("angle", [90, -180, 270, 30, -47.5])
@pytest.mark.parametrize("shape", [(33, 40), (24, 24, 2)])
def test_cv_rotate_matches_jax(shape, angle):
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    got, want = img.cv_rotate(x, angle), jimg.cv_rotate(x, angle)
    assert got.shape == want.shape
    if angle % 90 == 0:
        assert np.array_equal(got, want)
    np.testing.assert_allclose(got, want, atol=TOL_RESAMPLE)


# windows, crops and patches ----------------------------------------------

def test_get_imgstack_matches_jax(frames):
    frame = frames[0].copy()
    frame[40:44, 40:44] = np.nan         # windows over a NaN are dropped
    c = np.random.RandomState(4).uniform(-4, 100, (60, 2))
    got, want = img.get_imgstack(frame, c, 12), jimg.get_imgstack(frame, c,
                                                                  12)
    assert all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(got, want))
    assert img.get_imgstack(frame, c[:0], 12) == (None, None)
    assert img.get_imgstack(frame, np.array([[-50.0, -50.0]]), 12) == \
        (None, None)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_crops_match_jax(frames, seed):
    frame = frames[1]
    for a, b in zip(img.imcrop_randpx(frame, 16, 40, seed),
                    jimg.imcrop_randpx(frame, 16, 40, seed)):
        assert np.array_equal(a, b)
    c = np.random.RandomState(seed).uniform(10, 80, (50, 2))
    for a, b in zip(img.imcrop_randcoord(frame, c, 16, 20, seed),
                    jimg.imcrop_randcoord(frame, c, 16, 20, seed)):
        assert np.array_equal(a, b)


def test_extract_random_subimages_matches_jax(frames):
    for a, b in zip(img.extract_random_subimages(frames, 16, 12),
                    jimg.extract_random_subimages(frames, 16, 12)):
        assert np.array_equal(a, b)
    rng = np.random.RandomState(6)
    coord = {i: np.concatenate([rng.uniform(0, 96, (40, 2)),
                                rng.randint(0, 2, (40, 1))], 1)
             for i in range(len(frames))}
    for a, b in zip(
            img.extract_random_subimages(frames, 16, 5, coord,
                                         coord_class=1),
            jimg.extract_random_subimages(frames, 16, 5, coord,
                                          coord_class=1)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="cannot be greater"):
        img.extract_random_subimages(frames, 16, 500, coord)


@pytest.mark.parametrize("patch", [8, (12, 20)])
def test_extract_patches_match_jax(frames, patch):
    masks = (frames > 0.5).astype(np.float32)
    for a, b in zip(img.extract_patches(frames, masks, patch, 7,
                                        random_state=3),
                    jimg.extract_patches(frames, masks, patch, 7,
                                         random_state=3)):
        assert np.array_equal(a, b)
    for a, b in zip(img.extract_patches_(frames[0], masks[0], patch, 5),
                    jimg.extract_patches_(frames[0], masks[0], patch, 5)):
        assert np.array_equal(a, b)
    for a, b in zip(img.extract_patches(frames[0], masks[0], patch, 4),
                    jimg.extract_patches(frames[0], masks[0], patch, 4)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cube_shape,kw", [
    ((40, 40, 32), {}), ((40, 40, 32), {"band": [4, 9], "avg_pool": 4}),
    ((40, 40, 8, 6), {"band": [1, 3]}),
    ((40, 40, 8, 6), {"band": [1, 3, 0, 2], "avg_pool": (2, 3)})])
def test_extract_patches_and_spectra_matches_jax(cube_shape, kw):
    rng = np.random.RandomState(8)
    cube = rng.rand(*cube_shape).astype(np.float32)
    c = rng.uniform(0, 40, (30, 2))
    for a, b in zip(img.extract_patches_and_spectra(
                        cube, coordinates=c, window_size=8, **kw),
                    jimg.extract_patches_and_spectra(
                        cube, coordinates=c, window_size=8, **kw)):
        assert np.array_equal(a, b)
    image = rng.rand(40, 40)
    for a, b in zip(img.extract_patches_and_spectra(
                        cube, image, coordinates=c, window_size=8),
                    jimg.extract_patches_and_spectra(
                        cube, image, coordinates=c, window_size=8)):
        assert np.array_equal(a, b)


def test_extract_patches_and_spectra_checks_dims():
    with pytest.raises(ValueError, match="3D or 4D"):
        img.extract_patches_and_spectra(np.zeros((4, 4)))
    with pytest.raises(ValueError, match="2D"):
        img.extract_patches_and_spectra(np.zeros((4, 4, 3)),
                                        np.zeros((4, 4, 1)))


# FFT helpers and thresholds ----------------------------------------------

@pytest.mark.parametrize("maskratio", [10, 4])
def test_fft_helpers_match_jax(frames, maskratio):
    x = frames[0].astype(np.float64)
    got, want = img.FFTmask(x, maskratio), jimg.FFTmask(x, maskratio)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL_FFT)
    diff = img.FFTsub(x, got[1])
    np.testing.assert_allclose(diff, jimg.FFTsub(x, want[1]), atol=TOL_FFT)
    for lo, hi in ((0.25, 0.75), (0.1, 0.5)):
        assert np.array_equal(img.threshImg(diff, lo, hi),
                              jimg.threshImg(diff, lo, hi))
    for t in (0.5, 0.2):
        got_t = img.cv_thresh(frames, t)
        assert got_t.dtype == np.float32
        assert np.array_equal(got_t, jimg.cv_thresh(frames, t))


# the labeller's functions --------------------------------------------------

@pytest.mark.parametrize("filter_,thresh", [("below", 20), ("above", 20),
                                            ("below", 150)])
@pytest.mark.parametrize("im_thresh", [0.5, 0.3])
def test_filter_cells_matches_jax(frames, im_thresh, filter_, thresh):
    got = img.filter_cells(frames, im_thresh, thresh, filter_, **CPU)
    want = jimg.filter_cells(frames, im_thresh, thresh, filter_)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(
        img.filter_cells_(frames[0].astype(np.float64), im_thresh, thresh,
                          filter_, **CPU),
        jimg.filter_cells_(frames[0].astype(np.float64), im_thresh, thresh,
                           filter_))


def test_filter_cells_on_a_tensor_keeps_its_dtype(frames):
    t = torch.from_numpy(frames[0]).double()
    got = img.filter_cells_(t, 0.5, 20)      # a CPU tensor stays there
    assert got.dtype == np.float64
    assert np.array_equal(got, jimg.filter_cells_(frames[0], 0.5, 20))


@pytest.mark.parametrize("thresh", [0.5, 0.2, 0.95])
def test_get_contours_matches_jax(frames, thresh):
    for f in frames:
        mask = (f > thresh).astype(np.float32)
        got, want = img.get_contours(mask, **CPU), jimg.get_contours(mask)
        assert len(got) == len(want)
        assert all(a.dtype == np.int64 and np.array_equal(a, b)
                   for a, b in zip(got, want))


def test_get_contours_of_empty_and_full_masks():
    assert img.get_contours(np.zeros((8, 9)), **CPU) == \
        jimg.get_contours(np.zeros((8, 9))) == []
    full = img.get_contours(np.ones((8, 9)), **CPU)
    assert len(full) == 1
    assert np.array_equal(full[0], jimg.get_contours(np.ones((8, 9)))[0])


@pytest.mark.parametrize("filter_,thresh", [("below", 10), ("above", 60)])
def test_get_blob_params_matches_jax(frames, filter_, thresh):
    for nn_output in (frames, frames[..., None]):
        got = img.get_blob_params(nn_output, 0.4, thresh, filter_, **CPU)
        want = jimg.get_blob_params(nn_output, 0.4, thresh, filter_)
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(got[k]["decoded"], want[k]["decoded"])
            assert got[k]["coordinates"].shape == \
                want[k]["coordinates"].shape
            assert len(got[k]["coordinates"]) > 3
            np.testing.assert_allclose(got[k]["coordinates"],
                                       want[k]["coordinates"],
                                       rtol=0, atol=TOL_BLOB)
            assert got[k]["angles"].shape == want[k]["angles"].shape
            assert axis_diff(got[k]["angles"], want[k]["angles"]).max() \
                <= TOL_BLOB


def test_blob_moments_of_shapes():
    """Exact angles of shapes whose moments are known: a bar along the
    columns (90), a bar along the rows (180), a disc (90); a thick
    diagonal beside them; an empty mask."""
    m = np.zeros((40, 40), bool)
    m[5:7, 2:20] = True                          # along x (columns)
    m[10:30, 30:32] = True                       # along y (rows)
    m[np.arange(20, 30), np.arange(5, 15)] = True
    m[np.arange(20, 30), np.arange(6, 16)] = True  # the x = y diagonal
    yy, xx = np.mgrid[:40, :40]
    m |= (yy - 33) ** 2 + (xx - 33) ** 2 <= 9      # a disc
    com, ang = img._blob_moments(torch.from_numpy(m))
    jcom, jang = jimg._blob_moments(m.astype(np.float32))
    np.testing.assert_allclose(com, jcom, atol=TOL_BLOB)
    assert axis_diff(ang, jang).max() <= TOL_BLOB
    assert ang[[0, 1, 3]].tolist() == [90.0, 180.0, 90.0]
    assert 134 < ang[2] < 135
    assert img._blob_moments(torch.zeros((4, 4), dtype=torch.bool)) == \
        (None, None)


def test_get_blob_params_of_an_empty_frame():
    out = img.get_blob_params(np.zeros((2, 16, 16)), 0.5, 5, **CPU)
    assert out[0]["coordinates"] is None and out[0]["angles"].size == 0


@pytest.mark.parametrize("thresh", [0.5, 0.1])
def test_find_com_matches_jax(frames, thresh):
    for f in frames:
        mask = (f > thresh).astype(np.float32)
        got, want = coords.find_com(mask, **CPU), jcoords.find_com(mask)
        assert got.dtype == np.float32 and got.shape == want.shape
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= ulp).all()
    # a tensor is labelled on its own device
    t = torch.from_numpy(frames[0] > thresh)
    assert np.array_equal(coords.find_com(t), coords.find_com(
        frames[0] > thresh, **CPU))


# multiclass masks -----------------------------------------------------------

@pytest.mark.parametrize("classes", [(0, 1), (1, 2, 3)])
def test_create_multiclass_lattice_mask_matches_jax(classes):
    rng = np.random.RandomState(9)
    imgs = rng.rand(2, 64, 64)
    xyz = {i: np.concatenate([rng.uniform(-2, 66, (30, 2)),
                              rng.choice(classes, (30, 1))], 1)
           for i in range(2)}
    got = imgen.create_multiclass_lattice_mask(imgs, xyz, scale=7, rmask=5)
    want = jimgen.create_multiclass_lattice_mask(imgs, xyz, scale=7,
                                                 rmask=5)
    assert np.array_equal(got, want)
    one = imgen.create_multiclass_lattice_mask(imgs[0], xyz[0])
    assert np.array_equal(one, jimgen.create_multiclass_lattice_mask(
        imgs[0], xyz[0]))
    assert one.shape == (1, 64, 64, len(classes) + 1)


# coordinates ------------------------------------------------------------------

def _frames_coords(n=3, seed=0):
    rng = np.random.RandomState(seed)
    _, _, xy = make_lattice_stack(n_images=n, size=128, spacing=12,
                                  seed=seed)
    return {i: np.concatenate([c, rng.randint(0, 2, (len(c), 1))], 1)
            for i, c in enumerate(xy)}


@pytest.mark.parametrize("nn,ub", [(2, None), (3, 14.0), (1, 10.0)])
def test_get_nn_distances_matches_jax(nn, ub):
    c = _frames_coords()
    for got, want in zip(coords.get_nn_distances(c, nn, ub),
                         jcoords.get_nn_distances(c, nn, ub)):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for a, b in zip(coords.get_nn_distances_(c[0], nn, ub),
                    jcoords.get_nn_distances_(c[0], nn, ub)):
        assert np.array_equal(a, b)


def test_map_bonds_matches_jax_without_plots(tmp_path, monkeypatch):
    """Without ``plot_results`` the port draws nothing (the JAX package
    writes frame_<i>.png into the working directory)."""
    monkeypatch.chdir(tmp_path)
    c = _frames_coords()
    got = coords.map_bonds(c, 2, plot_results=False)
    assert list(tmp_path.iterdir()) == []
    assert np.array_equal(got, jcoords.map_bonds(c, 2, plot_results=False))


def test_gaussian_2d_matches_jax():
    xy = np.meshgrid(np.arange(9.0), np.arange(7.0))
    for p in ((1.0, 4, 3, 1.5, 2.5, 0.3, 0.1), (2.0, 1, 5, 0.7, 0.7, 0, 0)):
        assert np.array_equal(coords.gaussian_2d(xy, *p),
                              jcoords.gaussian_2d(xy, *p))


@pytest.mark.parametrize("rmax", [3, 8])
def test_find_coord_clusters_matches_jax(rmax):
    c1 = _frames_coords(seed=1)
    c2 = {k: v + np.random.RandomState(k).normal(0, 1, v.shape) * [1, 1, 0]
          for k, v in c1.items()}
    got = coords.find_coord_clusters(c1, c2, rmax)
    want = jcoords.find_coord_clusters(c1, c2, rmax)
    assert np.array_equal(got[0], want[0], equal_nan=True)
    assert np.array_equal(got[1], want[1], equal_nan=True)
    assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


def test_compare_coordinates_plots(tmp_path):
    c1 = _frames_coords()[0][:, :2]
    c2 = c1 + 0.4
    got = coords.compare_coordinates(c1, c2, 1.0, plot_results=True,
                                     expdata=np.zeros((128, 128)))
    want = jcoords.compare_coordinates(c1, c2, 1.0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(AssertionError, match="expdata"):
        coords.compare_coordinates(c1, c2, 1.0, plot_results=True)
