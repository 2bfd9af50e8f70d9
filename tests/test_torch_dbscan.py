"""The port's host DBSCAN (``atomai_tpu_torch/native``) against its plain
version, the JAX package's ``atomai_tpu.native.neighbors.dbscan`` and, where
it is installed, sklearn: equal labels (noise -1, clusters numbered by their
first core point, a border point in the first cluster that reaches it).
Then ``cluster_coord`` against the JAX function on the same coordinates,
and against a plain per-label loop written out here.
"""

import os

import numpy as np
import pytest
import torch

from atomai_tpu.native import neighbors as jneighbors
from atomai_tpu.utils import coords as jcoords
from atomai_tpu_torch import native
from atomai_tpu_torch.native import neighbors
from atomai_tpu_torch.ops import _build
from atomai_tpu_torch.utils import cluster_coord
from atomai_tpu_torch.utils import coords as tcoords

torch.set_num_threads(1)

TOL_MEAN = 1e-12     # float64 means of the same points


def _lattice_detections(seed, n_members=4, jitter=0.15, noise=6):
    """An ensemble's detections of a 6 x 6 lattice: each member finds each
    atom with a small jitter, a few atoms are missed, a few false hits."""
    rng = np.random.RandomState(seed)
    atoms = np.stack(np.meshgrid(np.arange(6) * 8.0 + 4,
                                 np.arange(6) * 8.0 + 4), -1).reshape(-1, 2)
    pts = []
    for _ in range(n_members):
        keep = rng.rand(len(atoms)) > 0.1
        pts.append(atoms[keep] + jitter * rng.randn(keep.sum(), 2))
    pts.append(rng.rand(noise, 2) * 48)
    return np.concatenate(pts)


CASES = {
    "random": (lambda: np.random.RandomState(0).rand(300, 2) * 20, 1.0, 4),
    "random_3d": (lambda: np.random.RandomState(1).rand(200, 3) * 6, 1.0, 5),
    "lattice_noise": (lambda: _lattice_detections(2), 0.5, 3),
    "lattice_dense": (lambda: _lattice_detections(3, n_members=10,
                                                  noise=20), 0.5, 10),
    "one_point": (lambda: np.array([[3.0, 4.0]]), 0.5, 1),
    "one_point_noise": (lambda: np.array([[3.0, 4.0]]), 0.5, 2),
    "all_noise": (lambda: np.arange(40, dtype=float).reshape(20, 2) * 10,
                  0.5, 2),
    "duplicates": (lambda: np.repeat(np.random.RandomState(4).rand(15, 2) * 5,
                                     3, axis=0), 0.3, 3),
    "empty": (lambda: np.zeros((0, 2)), 0.5, 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_equals_reference_and_jax(name):
    make, eps, min_samples = CASES[name]
    pts = make()
    got = neighbors.dbscan(pts, eps, min_samples)
    ref = neighbors.dbscan_reference(pts, eps, min_samples)
    assert got.dtype == np.int64 and got.shape == (len(pts),)
    np.testing.assert_array_equal(got, ref)
    if not len(pts):
        return      # the JAX package and sklearn refuse an empty set
    np.testing.assert_array_equal(got, jneighbors.dbscan(pts, eps,
                                                         min_samples))
    try:
        from sklearn.cluster import DBSCAN
    except ImportError:
        return
    np.testing.assert_array_equal(
        got, DBSCAN(eps=eps, min_samples=min_samples).fit(pts).labels_)


def test_case_outcomes():
    """The cases reach what they are named for."""
    assert (neighbors.dbscan(*_args("all_noise")) == -1).all()
    assert neighbors.dbscan(*_args("one_point")).tolist() == [0]
    assert neighbors.dbscan(*_args("one_point_noise")).tolist() == [-1]
    lab = neighbors.dbscan(*_args("lattice_noise"))
    assert 30 <= lab.max() + 1 <= 36 and (lab == -1).any()
    lab = neighbors.dbscan(*_args("duplicates"))
    assert len(set(lab[::3])) > 1


def _args(name):
    make, eps, min_samples = CASES[name]
    return make(), eps, min_samples


def test_build_goes_to_the_build_dir_and_needs_gxx(monkeypatch):
    path = _build.compile_shared(neighbors.SOURCE, "g++", neighbors.GXX_FLAGS)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libneighbors-")
    assert path == _build.compile_shared(neighbors.SOURCE, "g++",
                                         neighbors.GXX_FLAGS)
    monkeypatch.setattr(neighbors, "_lib", None)
    monkeypatch.setattr(neighbors.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        neighbors.dbscan(np.zeros((3, 2)), 0.5, 2)
    with pytest.raises(ValueError, match="points"):
        neighbors.dbscan_reference(np.zeros((3, 4)), 0.5, 2)
    assert native.dbscan is neighbors.dbscan


@pytest.mark.parametrize("seed", [5, 6])
def test_cluster_coord_matches_jax(seed):
    """Per-member (n, 3) [row, col, class] coordinates of one frame."""
    rng = np.random.RandomState(seed)
    det = _lattice_detections(seed)
    split = np.array_split(rng.permutation(len(det)), 4)
    coords = {m: np.concatenate([det[idx], np.zeros((len(idx), 1))], 1)
              for m, idx in enumerate(split)}
    got = cluster_coord(coords, 0.5, 3)
    want = jcoords.cluster_coord(coords, 0.5, 3)
    assert len(got[0]) == len(want[0]) > 30
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1], want[1], atol=TOL_MEAN, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=TOL_MEAN, rtol=0)


def test_cluster_coord_empty_and_no_noise():
    empty = {0: np.zeros((0, 3)), 1: np.zeros((0, 3))}
    c, mean, var = cluster_coord(empty, 0.5, 2)
    assert len(c) == 0 and mean.shape == var.shape == (0, 2)
    # every point in a cluster: no label is dropped (original atomai drops
    # the first label whether or not it is noise)
    pts = {0: np.array([[1.0, 1.0, 0], [10.0, 10.0, 0]]),
           1: np.array([[1.1, 1.0, 0], [10.0, 10.1, 0]])}
    _, mean, _ = cluster_coord(pts, 0.5, 2)
    np.testing.assert_allclose(mean, [[1.05, 1.0], [10.0, 10.05]])


def _loop_cluster_coord(coordinates_all, labels):
    """The plain version: one pass over the points per label."""
    clusters, clusters_var, clusters_mean = [], [], []
    for lbl in np.unique(labels[labels >= 0]):
        coord = coordinates_all[np.where(labels == lbl)]
        clusters.append(coord)
        clusters_mean.append(np.mean(coord[:, :2], axis=0))
        clusters_var.append(np.var(coord[:, :2], axis=0))
    return (np.array(clusters, dtype=object), np.array(clusters_mean),
            np.array(clusters_var))


def _members(points, n_members=4, seed=0):
    """(n, 2) points dealt at random to ``n_members`` members as (m, 3)
    [row, col, class] rows with a random class."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([points, rng.randint(0, 3, (len(points), 1))], 1)
    split = np.array_split(rng.permutation(len(rows)), n_members)
    return {m: rows[idx] for m, idx in enumerate(split)}


def _full_lattice(n_members=4, jitter=0.15, seed=0):
    """Every member finds every atom of the 6 x 6 lattice."""
    rng = np.random.RandomState(seed)
    atoms = np.stack(np.meshgrid(np.arange(6) * 8.0 + 4,
                                 np.arange(6) * 8.0 + 4), -1).reshape(-1, 2)
    return {m: np.concatenate([atoms + jitter * rng.randn(*atoms.shape),
                               np.full((len(atoms), 1), m)], 1)
            for m in range(n_members)}


# name: (coordinates, eps, min_samples, labels in place of DBSCAN's or None,
#        what the case has to reach)
GROUP_CASES = {
    "ragged_with_noise": (lambda: _members(_lattice_detections(7)), 0.5, 3,
                          None, "ragged_noise"),
    "all_clustered": (lambda: _members(_lattice_detections(8, noise=0)),
                      0.5, 1, None, "ragged_no_noise"),
    "same_size": (lambda: _full_lattice(), 0.5, 3, None, "same_size"),
    "single_cluster": (lambda: _members(
        3.0 + 0.1 * np.random.RandomState(9).randn(7, 2), 2), 0.5, 3, None,
        "same_size"),
    "labels_with_gaps": (lambda: _members(
        np.random.RandomState(10).rand(40, 2) * 30, 3), 0.5, 3,
        np.random.RandomState(11).choice([-1, 0, 3, 4, 9], 40),
        "ragged_noise"),
    "all_noise": (lambda: _members(np.arange(24.0).reshape(12, 2) * 10, 3),
                  0.5, 2, None, "all_noise"),
}


@pytest.mark.parametrize("name", sorted(GROUP_CASES))
def test_cluster_coord_matches_plain_loop(name, monkeypatch):
    make, eps, min_samples, labels, reach = GROUP_CASES[name]
    coords = make()
    coordinates_all = np.concatenate([coords[k] for k in range(len(coords))])
    if labels is None:
        labels = native.dbscan(coordinates_all[:, :2], eps, min_samples)
    else:
        monkeypatch.setattr(tcoords, "dbscan", lambda *args: labels)
    sizes = np.bincount(labels[labels >= 0], minlength=1)
    sizes = sizes[sizes > 0]
    assert {"ragged_noise": (labels == -1).any() and len(set(sizes)) > 1,
            "ragged_no_noise": (labels >= 0).all() and len(set(sizes)) > 1,
            "same_size": len(set(sizes)) == 1,
            "all_noise": (labels == -1).all()}[reach]
    got = cluster_coord(coords, eps, min_samples)
    want = _loop_cluster_coord(coordinates_all, labels)
    assert got[0].dtype == want[0].dtype == object
    assert got[0].shape == want[0].shape
    if reach == "same_size":
        assert got[0].ndim == 3
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.shape == ((len(sizes), 2) if len(sizes) else (0,))
        np.testing.assert_allclose(g, w, atol=TOL_MEAN, rtol=0)
