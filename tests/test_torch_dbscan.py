"""The port's host DBSCAN (``atomai_tpu_torch/native``) against its plain
version, the JAX package's ``atomai_tpu.native.neighbors.dbscan`` and, where
it is installed, sklearn: equal labels (noise -1, clusters numbered by their
first core point, a border point in the first cluster that reaches it).
Then ``cluster_coord`` against the JAX function on the same coordinates.
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
