"""The stat layer (``atomai_tpu_torch/stat``) against the JAX package's on
the CPU: the decompositions from the same numpy ``RandomState`` draws,
``imlocal`` and its trajectories and transitions, ``SpectralUnmixer``,
``SlidingFFTNMF`` (the linear zoom's borders included), ``update_classes``
for every method (the mean shift against scikit-learn), and the utils
they use.

Tolerances (float32 on both sides; measured values in parentheses):
- one-shot linear algebra (PCA, whitening): 1e-4 of the output's scale
  (<= 1.4e-5);
- iterated maps (200 FastICA steps, up to 1000 NMF updates, the FFT-NMF):
  1e-3 of scale (<= 3e-5): rounding differences of the two float32
  stacks grow a little along the iterations;
- labels (KMeans, GMM, mean shift, update_classes): equal, on data whose
  clusters are separated; the GMM's means 1e-4 of scale;
- the zoomed spectra: 1e-5 of scale (<= 1e-6), edge rows and columns
  included.
"""

import os

import jax
import numpy as np
import pytest
import torch

import atomai_tpu as J
import atomai_tpu_torch as T

torch.set_num_threads(1)

CPU = dict(device="cpu")
TOL_LIN = 1e-4
TOL_ITER = 1e-3


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.RandomState(0)
    centres = rng.randn(4, 12) * 4
    X = np.concatenate([c + rng.randn(60, 12) for c in centres])
    return X.astype(np.float32)


# ------------------------------------------------------- decompositions
def test_pca(blobs):
    j = J.stat.PCA(5)
    t = T.stat.PCA(5, **CPU)
    assert _scaled(t.fit_transform(blobs), j.fit_transform(blobs)) <= TOL_LIN
    assert _scaled(t.components_, j.components_) <= TOL_LIN
    assert _scaled(t.explained_variance_ratio_,
                   j.explained_variance_ratio_) <= TOL_LIN
    x = blobs[:7] + 0.5
    assert _scaled(t.transform(x), j.transform(x)) <= TOL_LIN
    full = T.stat.PCA(**CPU).fit(blobs)
    assert full.components_.shape == (12, 12)
    # sklearn's sign rule: each component's largest entry is positive
    idx = np.abs(full.components_).argmax(1)
    assert (full.components_[np.arange(12), idx] > 0).all()


def test_fast_ica(blobs):
    j = J.stat.FastICA(4, random_state=3)
    t = T.stat.FastICA(4, random_state=3, **CPU)
    assert _scaled(t.fit_transform(blobs), j.fit_transform(blobs)) \
        <= TOL_ITER
    assert _scaled(t.components_, j.components_) <= TOL_ITER
    assert _scaled(t.transform(blobs[:5]), j.transform(blobs[:5])) \
        <= TOL_ITER


def test_nmf(blobs):
    X = np.abs(blobs)
    j = J.stat.NMF(3, max_iter=400)
    t = T.stat.NMF(3, max_iter=400, **CPU)
    assert _scaled(t.fit_transform(X), j.fit_transform(X)) <= TOL_ITER
    assert _scaled(t.components_, j.components_) <= TOL_ITER
    assert _scaled(t.transform(X[:9]), j.transform(X[:9])) <= TOL_ITER
    # a tensor on the device is taken as it is
    t2 = T.stat.NMF(3, max_iter=400, **CPU)
    assert _scaled(t2.fit_transform(torch.from_numpy(X)),
                   j.fit_transform(X)) <= TOL_ITER


def test_kmeans(blobs):
    j = J.stat.KMeans(4, random_state=5).fit(blobs)
    t = T.stat.KMeans(4, random_state=5, **CPU).fit(blobs)
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert _scaled(t.cluster_centers_, j.cluster_centers_) <= TOL_LIN
    np.testing.assert_array_equal(t.predict(blobs[::3]),
                                  j.predict(blobs[::3]))


@pytest.mark.parametrize("cov", ["diag", "full", "tied", "spherical"])
def test_gaussian_mixture(blobs, cov):
    j = J.stat.GaussianMixture(4, cov, random_state=2)
    t = T.stat.GaussianMixture(4, cov, random_state=2, **CPU)
    np.testing.assert_array_equal(t.fit_predict(blobs), j.fit_predict(blobs))
    assert t.covariance_type == j.covariance_type
    assert t.reg_covar == j.reg_covar == 1e-6
    assert _scaled(t.means_, j.means_) <= TOL_LIN
    assert _scaled(t.covariances_, j.covariances_) <= TOL_LIN
    np.testing.assert_array_equal(t.predict(blobs[::2]), j.predict(blobs[::2]))


def test_chunked_pairwise_terms(blobs, monkeypatch):
    """The (n, k, d) terms taken in row chunks give the one-block result."""
    from atomai_tpu_torch.stat import decomposition
    want = T.stat.GaussianMixture(4, "diag", **CPU).fit_predict(blobs)
    monkeypatch.setattr(decomposition, "CHUNK", 97)
    got = T.stat.GaussianMixture(4, "diag", **CPU).fit_predict(blobs)
    np.testing.assert_array_equal(got, want)


def test_ica_decorrelation_is_the_polar_factor():
    from atomai_tpu_torch.stat.decomposition import _sym_decorrelate
    W = torch.from_numpy(np.random.RandomState(1).randn(5, 5)
                         .astype(np.float32))
    got = _sym_decorrelate(W).double().numpy()
    u, _, vt = np.linalg.svd(W.double().numpy())
    np.testing.assert_allclose(got, u @ vt, atol=1e-6)


# -------------------------------------------------------------- imlocal
@pytest.fixture(scope="module")
def lattice():
    imgs, _, xy = J.utils.make_lattice_stack(n_images=4, size=64,
                                             spacing=8, seed=0)
    rng = np.random.RandomState(1)
    coords = {i: np.concatenate([c + rng.randn(*c.shape) * 0.3,
                                 np.zeros((len(c), 1))], 1)
              for i, c in enumerate(xy)}
    return imgs[..., None].astype(np.float32), coords


@pytest.fixture(scope="module")
def local(lattice):
    nn, coords = lattice
    return (J.stat.imlocal(nn, coords, 8),
            T.stat.imlocal(nn, coords, 8, **CPU))


@pytest.mark.parametrize("method", ["pca", "ica", "nmf", "imblock_pca",
                                    "imblock_ica", "imblock_nmf"])
def test_imlocal_decompositions(local, method):
    j, t = local
    np.testing.assert_array_equal(t.imgstack, j.imgstack)
    a, b = getattr(j, method)(3), getattr(t, method)(3)
    tol = TOL_LIN if method.endswith("pca") else TOL_ITER
    assert b[0].shape == a[0].shape == (3, 8, 8, 1)
    assert _scaled(b[0], a[0]) <= tol and _scaled(b[1], a[1]) <= tol
    np.testing.assert_array_equal(b[2], a[2])


def test_imlocal_gmm_and_scree(local):
    j, t = local
    a, b = j.gmm(3), t.gmm(3)
    np.testing.assert_array_equal(b[2], a[2])
    assert _scaled(b[0], a[0]) <= TOL_LIN
    assert [len(c) for c in b[1]] == [len(c) for c in a[1]]
    assert _scaled(t.pca_scree_plot(plot_results=False),
                   j.pca_scree_plot(plot_results=False)) <= TOL_LIN
    for x, y in zip(t.pca_gmm_scree_plot(3, plot_results=False),
                    j.pca_gmm_scree_plot(3, plot_results=False)):
        assert x.shape == y.shape and (not len(y) or
                                       _scaled(x, y) <= TOL_LIN)
    t.gmm(3, plot_results=True)                  # plots on the Agg backend
    t.pca_scree_plot(plot_results=True)
    T.stat.imlocal.plot_decomposition_results(b[0], None)
    a, b = j.pca_gmm(3, 2), t.pca_gmm(3, 2)
    for x, y in zip(b[1], a[1]):
        assert _scaled(x, y) <= TOL_LIN
    np.testing.assert_array_equal(b[3], a[3])


def test_imlocal_trajectories_and_transitions(local, lattice):
    j, t = local
    a = j.transition_matrix(3, rmax=3, sum_all_transitions=True)
    b = t.transition_matrix(3, rmax=3, sum_all_transitions=True)
    assert len(b["trajectories"]) == len(a["trajectories"]) > 10
    for x, y in zip(b["trajectories"], a["trajectories"]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(b["transitions"], a["transitions"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b["all_transitions"], a["all_transitions"])
    np.testing.assert_array_equal(b["gmm_components"], a["gmm_components"])
    _, coords = lattice
    fa = j.get_trajectory(coords, coords[0][5, :2], 3)
    fb = t.get_trajectory(coords, coords[0][5, :2], 3)
    for x, y in zip(fb, fa):
        np.testing.assert_array_equal(x, y)


def test_transition_helpers(tmp_path):
    rng = np.random.RandomState(4)
    trace = rng.randint(0, 4, 50)
    np.testing.assert_array_equal(
        T.stat.calculate_transition_matrix(trace),
        J.stat.calculate_transition_matrix(trace))
    trajs = [np.concatenate([rng.rand(20, 2), rng.randint(1, 4, (20, 1))],
                            1) for _ in range(3)]
    d = {"trajectories": trajs, "transitions": [
        T.stat.calculate_transition_matrix(
            T.stat.imlocal.renumerate_classes(x[:, -1])) for x in trajs]}
    np.testing.assert_array_equal(T.stat.sum_transitions(d, 3),
                                  J.stat.sum_transitions(d, 3))
    out = tmp_path / "tm.png"
    from atomai_tpu_torch.utils.viz import plot_transitions
    plot_transitions(T.stat.sum_transitions(d, 3), plot_values=True,
                     savefig=str(out))
    assert out.stat().st_size > 0


# -------------------------------------------------------------- unmixer
@pytest.mark.parametrize("method", ["nmf", "pca", "ica", "gmm"])
@pytest.mark.parametrize("normalize", [False, True])
def test_spectral_unmixer(method, normalize):
    rng = np.random.RandomState(0)
    ends = np.abs(rng.randn(3, 40)).astype(np.float32)
    ab = rng.dirichlet(np.ones(3), size=(10, 12)).astype(np.float32)
    cube = ab @ ends + 0.01 * np.abs(rng.randn(10, 12, 40)).astype(
        np.float32)
    kw = dict(max_iter=300) if method == "nmf" else {}
    a = J.stat.SpectralUnmixer(method, 3, normalize=normalize,
                               **kw).fit(cube)
    b = T.stat.SpectralUnmixer(method, 3, normalize=normalize, **CPU,
                               **kw).fit(cube)
    tol = TOL_LIN if method in ("pca", "gmm") else TOL_ITER
    assert b[1].shape == a[1].shape == (10, 12, 3)
    assert _scaled(b[0], a[0]) <= tol and _scaled(b[1], a[1]) <= tol


# ------------------------------------------------------------ FFT + NMF
def test_linear_zoom_matches_jax_resize():
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(linear) for the integer upscales, borders included."""
    import torch.nn.functional as F
    x = np.random.RandomState(0).rand(3, 7, 9).astype(np.float32)
    for f in (2, 3, 4):
        want = np.asarray(jax.image.resize(x, (3, 7 * f, 9 * f), "linear"))
        got = F.interpolate(torch.from_numpy(x)[:, None], scale_factor=f,
                            mode="bilinear", align_corners=False)[:, 0]
        got = got.numpy()
        for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
                     np.s_[:, :, -1]):
            assert _scaled(got[edge], want[edge]) <= 1e-6
        assert _scaled(got, want) <= 1e-6


@pytest.mark.parametrize("kw", [dict(window_size_x=32, window_size_y=16,
                                     components=3),
                                dict(components=2, hamming_filter=False,
                                     interpolation_factor=3)])
def test_sliding_fft_nmf(lattice, kw, tmp_path):
    img = lattice[0][0, ..., 0] * 3 + 1
    img = np.concatenate([img, img[:, :40]], 1)          # 64 x 104
    j = J.stat.SlidingFFTNMF(**kw)
    t = T.stat.SlidingFFTNMF(**kw, **CPU)
    wa, wb = j.make_windows(img), t.make_windows(img)
    assert wb.shape == wa.shape and _scaled(wb, wa) <= 1e-6
    np.testing.assert_array_equal(t.pos_vec, j.pos_vec)
    fa, fb = j.process_fft(wa), t.process_fft(wb)
    assert fb.shape == fa.shape and t.fft_size == j.fft_size
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert _scaled(fb[edge], fa[edge]) <= 1e-5
    assert _scaled(fb, fa) <= 1e-5
    ca, aa = j.analyze_image(img, output_path=str(tmp_path / "j"))
    cb, ab = t.analyze_image(img, output_path=str(tmp_path / "t"))
    assert cb.shape == ca.shape and ab.shape == aa.shape
    assert _scaled(cb, ca) <= TOL_ITER and _scaled(ab, aa) <= TOL_ITER
    np.testing.assert_array_equal(np.load(tmp_path / "t_components.npy"),
                                  cb)


def test_sliding_fft_nmf_from_file(tmp_path):
    from PIL import Image
    img = (np.random.RandomState(3).rand(80, 80) * 255).astype(np.uint8)
    path = tmp_path / "frame.png"
    Image.fromarray(img).save(path)
    np.save(tmp_path / "frame.npy", img.astype(np.float32))
    for name in ("frame.png", "frame.npy"):
        np.testing.assert_array_equal(
            T.utils.load_image(str(tmp_path / name)),
            J.utils.img.load_image(str(tmp_path / name)))
    c, a = T.stat.SlidingFFTNMF(components=2, **CPU).analyze_image(
        str(path))
    assert os.path.exists(tmp_path / "frame_analysis_components.npy")
    assert c.shape[0] == a.shape[0] == 2


# --------------------------------------------------------- update_classes
@pytest.fixture(scope="module")
def two_kinds():
    """A lattice whose atoms have two brightnesses, and their coordinates."""
    imgs, _, xy = J.utils.make_lattice_stack(n_images=2, size=64, spacing=8,
                                             seed=0)
    rng = np.random.RandomState(2)
    out = imgs.copy()
    coords = {}
    for i, c in enumerate(xy):
        bright = rng.rand(len(c)) > 0.5
        for (r, q), b in zip(np.round(c).astype(int), bright):
            out[i, max(r - 1, 0):r + 2, max(q - 1, 0):q + 2] *= 2.0 if b \
                else 1.0
        coords[i] = np.concatenate([c, np.zeros((len(c), 1))], 1)
    return out, coords


@pytest.mark.parametrize("method,kw", [
    ("threshold", {}), ("kmeans", dict(n_components=2)),
    ("meanshift", dict(quantile=0.3)),
    ("gmm_local", dict(n_components=2, window_size=8))])
def test_update_classes(two_kinds, method, kw):
    imgs, coords = two_kinds
    if method == "threshold":
        kw = dict(thresh=float(np.median(np.concatenate(
            T.utils.get_intensities(coords, imgs)))))
    a = J.stat.update_classes(coords, imgs, method, **kw)
    b = T.stat.update_classes(coords, imgs, method, **CPU, **kw)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
    assert len(np.unique(np.concatenate([v[:, -1] for v in b.values()]))) \
        >= 2


@pytest.mark.parametrize("seed", range(4))
def test_mean_shift_matches_sklearn(seed):
    from sklearn.cluster import MeanShift, estimate_bandwidth
    rng = np.random.RandomState(seed)
    n = [40, 300, 1000, 57][seed]
    v = np.concatenate([rng.randn(n // 2) * 0.2, 3 + rng.randn(n - n // 2)])
    if seed == 3:
        v = np.round(v, 1)                    # ties and repeated values
    v = v[:, None]
    for q in (0.1, 0.25, 0.5):
        bw = estimate_bandwidth(v, quantile=q)
        assert T.stat.estimate_bandwidth_1d(v, q) == pytest.approx(
            bw, rel=1e-12)
        ref = MeanShift(bandwidth=bw, bin_seeding=True).fit(v)
        ours = T.stat.MeanShift1D(bw).fit(v)
        np.testing.assert_allclose(ours.cluster_centers_,
                                   ref.cluster_centers_, rtol=1e-12)
        np.testing.assert_array_equal(ours.predict(v), ref.predict(v))


# ----------------------------------------------------------------- utils
def test_intensity_and_coordinate_helpers(two_kinds):
    imgs, coords = two_kinds
    for r in (3, 4):
        for x, y in zip(T.utils.get_intensities(coords, imgs, r),
                        J.utils.coords.get_intensities(coords, imgs, r)):
            np.testing.assert_array_equal(x, y)
    c1 = coords[0][:, :2]
    c2 = c1[::-1] + np.random.RandomState(0).randn(*c1.shape) * 0.5
    for x, y in zip(T.utils.compare_coordinates(c1, c2, 1.0),
                    J.utils.coords.compare_coordinates(c1, c2, 1.0)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        T.utils.remove_edge_coord(coords[0], (64, 48), 6),
        J.utils.coords.remove_edge_coord(coords[0], (64, 48), 6))
