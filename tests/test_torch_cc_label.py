"""The port's connected-component labels and blob centres against the JAX
package (XLA loop and Pallas kernel in interpret mode) and a scipy oracle.

Labels are compared exactly; centres of mass within 1e-4 px (the JAX
package sums moments in float32, the port in int64); frames and sizes
exactly. The CUDA kernel itself runs only on the card (``chip_smoke.py``);
here the dispatcher must route CPU tensors to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from atomai_tpu.ops import cc_label as jax_cc
from atomai_tpu.ops.pallas_cc import label_components_pallas
from atomai_tpu_torch.ops import _build, cc_kernel, cc_label
from atomai_tpu_torch.ops import (blob_centers, blob_centers_tiled,
                                  label_components,
                                  label_components_reference, tile_frames)
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

TOL_PX = 1e-4


def _random_mask(seed, density, shape=(48, 40)):
    return np.random.RandomState(seed).rand(*shape) < density


def _scipy_labels(mask):
    """scipy.ndimage.label as minimal flat indices, H*W for background."""
    H, W = mask.shape
    lab, _ = ndimage.label(mask)
    flat = lab.ravel()
    values, first = np.unique(flat, return_index=True)
    root = np.full(values.max() + 1, H * W, np.int64)
    root[values] = first
    root[0] = H * W
    return root[flat].reshape(H, W)


def _label(mask):
    return label_components(torch.from_numpy(mask)).numpy()


@pytest.fixture(scope="module")
def lattice_masks():
    return make_lattice_stack(n_images=3, size=64, spacing=12, seed=1)[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.59, 0.9])
def test_plain_labels_equal_jax(seed, density):
    mask = _random_mask(seed, density)
    got = _label(mask)
    assert got.dtype == np.int32
    ref = np.asarray(jax_cc.label_components(jnp.asarray(mask, jnp.float32)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,density", [(0, 0.1), (1, 0.5), (2, 0.59)])
def test_plain_labels_equal_pallas_interpret(seed, density):
    mask = _random_mask(seed, density, (32, 128))
    ref = np.asarray(label_components_pallas(jnp.asarray(mask, jnp.float32),
                                             interpret=True))
    np.testing.assert_array_equal(_label(mask), ref)


def test_plain_labels_equal_jax_on_tiled_lattice(lattice_masks):
    tiled = tile_frames(torch.from_numpy(lattice_masks > 0)).numpy()
    ref = np.asarray(jax_cc.label_components(jnp.asarray(tiled,
                                                         jnp.float32)))
    np.testing.assert_array_equal(_label(tiled), ref)


def _spiral(n):
    m = np.zeros((n, n), bool)
    r = c = 0
    dr, dc = 0, 1
    lengths = [n - 1, n - 1, n - 1] + [k for k in range(n - 3, 0, -2)
                                       for _ in range(2)]
    m[0, 0] = True
    for length in lengths:
        for _ in range(length):
            r, c = r + dr, c + dc
            m[r, c] = True
        dr, dc = dc, -dr
    return m


@pytest.mark.parametrize("name", ["random", "zeros", "ones", "spiral",
                                  "one_row", "one_col"])
def test_plain_labels_equal_scipy(name):
    mask = {"random": _random_mask(7, 0.55, (37, 53)),
            "zeros": np.zeros((16, 24), bool),
            "ones": np.ones((16, 24), bool),
            "spiral": _spiral(33),
            "one_row": _random_mask(8, 0.6, (1, 70)),
            "one_col": _random_mask(9, 0.6, (70, 1))}[name]
    np.testing.assert_array_equal(_label(mask), _scipy_labels(mask))


def test_uint8_mask_labels_like_bool():
    mask = _random_mask(3, 0.5)
    got = label_components(torch.from_numpy(mask.astype(np.uint8) * 7))
    np.testing.assert_array_equal(got.numpy(), _label(mask))


def _jax_tiled(masks):
    c, f, s, v = jax_cc.blob_centers_tiled(jnp.asarray(masks, jnp.float32),
                                           8192)
    v = np.asarray(v)
    return np.asarray(c)[v], np.asarray(f)[v], np.asarray(s)[v]


def test_blob_centers_tiled_match_jax_on_lattice(lattice_masks):
    coords, frames, sizes = blob_centers_tiled(
        torch.from_numpy(lattice_masks > 0))
    jc, jf, js = _jax_tiled(lattice_masks)
    assert coords.dtype == torch.float32 and len(coords) == len(jc) > 0
    np.testing.assert_allclose(coords.numpy(), jc, atol=TOL_PX)
    np.testing.assert_array_equal(frames.numpy(), jf)
    np.testing.assert_array_equal(sizes.numpy(), js)


@pytest.mark.parametrize("seed", [0, 1])
def test_blob_centers_tiled_match_jax_on_random(seed):
    masks = np.random.RandomState(seed).rand(5, 23, 31) < 0.45
    coords, frames, sizes = blob_centers_tiled(torch.from_numpy(masks))
    jc, jf, js = _jax_tiled(masks)
    np.testing.assert_allclose(coords.numpy(), jc, atol=TOL_PX)
    np.testing.assert_array_equal(frames.numpy(), jf)
    np.testing.assert_array_equal(sizes.numpy(), js)


def test_blob_centers_match_jax_and_scipy():
    mask = _random_mask(4, 0.3, (40, 44))
    coords, sizes = blob_centers(torch.from_numpy(mask))
    jc, js, jv = jax_cc.blob_centers(jnp.asarray(mask, jnp.float32), 1024)
    jv = np.asarray(jv)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc)[jv],
                               atol=TOL_PX)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js)[jv])
    lab, n = ndimage.label(mask)
    com = np.array(ndimage.center_of_mass(mask, lab, np.arange(1, n + 1)))
    np.testing.assert_allclose(coords.numpy(), com, atol=TOL_PX)


def test_chunked_tiling_equals_one_chunk(lattice_masks, monkeypatch):
    """Stacks longer than the pixel budget run in chunks with the same
    result (frames offset by each chunk's start)."""
    masks = torch.from_numpy(lattice_masks > 0)
    whole = blob_centers_tiled(masks)
    monkeypatch.setattr(cc_label, "_TILED_PIXEL_BUDGET", 65 * 64)
    chunked = blob_centers_tiled(masks)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_tile_frames_separates_frames():
    masks = torch.ones((3, 4, 5), dtype=torch.bool)
    tiled = tile_frames(masks)
    assert tiled.shape == (15, 5)
    assert not tiled[4::5].any() and tiled.sum() == 60
    lab = label_components(tiled)
    assert len(torch.unique(lab)) == 4  # three frames + background


def test_cpu_tensor_takes_plain_path():
    before = cc_kernel.LAUNCHES
    mask = torch.from_numpy(_random_mask(5, 0.5))
    got = label_components(mask)
    assert cc_kernel.LAUNCHES == before
    assert torch.equal(got, label_components_reference(mask))


def test_other_devices_raise():
    mask = torch.zeros((8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        label_components(mask)


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_kernel.label_components_cuda(torch.zeros((4, 4), dtype=torch.bool))


@pytest.mark.parametrize("mask,error", [
    (torch.zeros((2, 4, 4), dtype=torch.bool), ValueError),
    (torch.zeros((4, 4), dtype=torch.float32), TypeError),
])
def test_bad_masks_raise(mask, error):
    with pytest.raises(error):
        label_components(mask)


def test_build_without_nvcc_raises(monkeypatch):
    """No compiler means an error, never a silent fallback."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_tracks_the_source():
    path = _build.library_path("cc_label.cu")
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path("cc_label.cu")
    assert path.endswith(".so") and "cc_label-" in path
