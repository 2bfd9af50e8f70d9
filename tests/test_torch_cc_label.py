"""The port's connected-component labels and blob centres against the JAX
package (XLA loop and Pallas kernel in interpret mode) and a scipy oracle.

Labels are compared exactly; centres of mass within 1e-4 px (the JAX
package sums moments in float32, the port in int64); frames and sizes
exactly. The CUDA kernel itself runs only on the card (``chip_smoke.py``);
here the dispatcher must route CPU tensors to the plain version.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from atomai_tpu.ops import cc_label as jax_cc
from atomai_tpu.ops.pallas_cc import label_components_pallas
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.ops import _build, cc_kernel, cc_label
from atomai_tpu_torch.ops import (blob_centers, blob_centers_tiled,
                                  blob_sums, blob_sums_reference,
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


def _launches():
    return profiling.summary()["counters"].get("labeller.launches", 0)


def test_cpu_tensor_takes_plain_path():
    before = _launches()
    mask = torch.from_numpy(_random_mask(5, 0.5))
    got = label_components(mask)
    assert _launches() == before
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


def test_byte_count_matches_hand_count():
    """Config A's tiled stack of 64 frames of 256² (64 x 257 rows):
    4,210,688 one-byte mask pixels in and as many int32 labels out, and
    with the fused sums 28 bytes a component (int32 root, int64 count, row
    and column sums): 64 components on the random-weight mask, 12,544 on
    the trained one. The labeller is memory-bound."""
    from atomai_tpu_torch.ops import roofline
    assert cc_kernel.cc_label_bytes(64 * 256, 256) == 20_971_520
    assert cc_kernel.cc_label_bytes(3, 7) == 105
    assert cc_kernel.cc_label_bytes(3, 7, blobs=2) == 105 + 56
    assert cc_kernel.cc_label_bytes(64 * 257, 256, blobs=64) == 21_055_232
    assert cc_kernel.cc_label_bytes(64 * 257, 256, blobs=12_544) \
        == 21_404_672
    t, by = roofline.bound(0, cc_kernel.cc_label_bytes(64 * 257, 256, 64))
    assert by == "bytes" and t == pytest.approx(21_055_232 / 3.35e9)


def test_root_capacity_counts_ragged_tiles():
    """One slot for every two pixels of every 32 x 64 tile, ragged edge
    tiles counted whole."""
    assert cc_kernel.root_capacity(32, 64) == 1024
    assert cc_kernel.root_capacity(33, 65) == 4 * 1024
    assert cc_kernel.root_capacity(64 * 257, 256) == 514 * 4 * 1024
    assert cc_kernel.root_capacity(4099, 2) == 129 * 1024


def test_kernel_constants_match_the_source():
    """The tile shape and the packing of a tile's partial sums in
    ``cc_kernel`` (used by the wrapper and the model below) are those of
    ``csrc/cc_label.cu``."""
    import re
    with open(os.path.join(_build.CSRC_DIR, "cc_label.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    def bits(name):
        return int(re.search(
            rf"{name} = \(1ull << (\d+)\) - 1;", src)[1])
    assert (const("kTileH"), const("kTileW")) == (cc_kernel.TILE_H,
                                                  cc_kernel.TILE_W)
    assert cc_kernel.PACK_COUNT == (0, bits("kCountMask"))
    assert cc_kernel.PACK_ROWS == (const("kRowShift"), bits("kRowMask"))
    assert cc_kernel.PACK_COLS == (const("kColShift"), bits("kColMask"))
    assert cc_kernel.PACK_WRAPS == (const("kWrapShift"), bits("kWrapMask"))
    fields = [cc_kernel.PACK_COUNT, cc_kernel.PACK_ROWS, cc_kernel.PACK_COLS,
              cc_kernel.PACK_WRAPS]
    for (s0, b0), (s1, _) in zip(fields, fields[1:]):
        assert s0 + b0 == s1   # adjacent, no overlap
    assert sum(b for _, b in fields) <= 64
    # the largest total of each field over one tile fits its width
    px = cc_kernel.TILE_H * cc_kernel.TILE_W
    assert px < 2 ** cc_kernel.PACK_COUNT[1]
    assert (cc_kernel.TILE_H - 1) * px < 2 ** cc_kernel.PACK_ROWS[1]
    assert (cc_kernel.TILE_W - 1) * px < 2 ** cc_kernel.PACK_COLS[1]
    assert (cc_kernel.TILE_H - 1) * px < 2 ** cc_kernel.PACK_WRAPS[1]


def _field(packed, field):
    shift, width = field
    return (packed >> shift) & ((1 << width) - 1)


def _find(parent, x):
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def _unite(parent, a, b):
    a, b = sorted((_find(parent, a), _find(parent, b)))
    parent[b] = a


def _local_roots(tile):
    """The kernel's union-find on one (32, 64) tile, in sequence: each
    pixel points to the first pixel of its run in the tile row; a pixel
    joins its upper neighbour unless its left neighbour and that one's
    upper neighbour are both foreground. Returns each pixel's tile-local
    root (-1 for background)."""
    tw = tile.shape[1]
    m = tile.reshape(-1)
    par = np.full(m.size, -1)
    for i in np.nonzero(m)[0]:
        par[i] = par[i - 1] if i % tw and m[i - 1] else i
    for i in np.nonzero(m)[0]:
        if i >= tw and m[i - tw] and not (i % tw and m[i - 1] and
                                          m[i - tw - 1]):
            _unite(par, i, i - tw)
    return np.array([_find(par, i) if m[i] else -1 for i in range(m.size)])


def _tile_model(mask, band=0):
    """numpy model of ``csrc/cc_label.cu``: label each 32 x 64 tile alone
    (:func:`_local_roots`), each pixel pointing at its tile-local root's
    global flat index; pack each tile-local component's count and local
    row, column and band-wrap sums into one integer as the kernel does;
    join the trees of the pixel pairs across tile borders (larger root
    linked to the smaller; a pair skipped where the pair beside it joins
    the same two parts, as the kernel skips it); relabel to the final
    roots; unpack each tile root's sums at its tile's origin and add them
    into its final root's. Returns labels (H, W) and (roots, counts,
    row_sums, col_sums) in ascending root order."""
    th, tw = cc_kernel.TILE_H, cc_kernel.TILE_W
    H, W = mask.shape
    n = H * W
    lab = np.full(n, n, np.int64)
    parts = {}
    for r0 in range(0, H, th):
        for c0 in range(0, W, tw):
            tile = np.zeros((th, tw), bool)
            part = mask[r0:r0 + th, c0:c0 + tw]
            tile[:part.shape[0], :part.shape[1]] = part
            root = _local_roots(tile)
            li = np.nonzero(root >= 0)[0]
            lr, lc = np.divmod(li, tw)
            rt = root[li]
            lab[(r0 + lr) * W + c0 + lc] = (r0 + rt // tw) * W + c0 + rt % tw
            wrap = (r0 + lr) // band - r0 // band if band else 0 * lr
            one = (1 << cc_kernel.PACK_COUNT[0]) \
                + (lr << cc_kernel.PACK_ROWS[0]) \
                + (lc << cc_kernel.PACK_COLS[0]) \
                + (wrap << cc_kernel.PACK_WRAPS[0])
            for t in np.unique(rt):
                sel = rt == t
                p = int(one[sel].sum())
                assert [_field(p, f) for f in (
                    cc_kernel.PACK_COUNT, cc_kernel.PACK_ROWS,
                    cc_kernel.PACK_COLS, cc_kernel.PACK_WRAPS)] == [
                    int(sel.sum()), int(lr[sel].sum()), int(lc[sel].sum()),
                    int(wrap[sel].sum())]          # no field overflowed
                parts[int((r0 + t // tw) * W + c0 + t % tw)] = p

    parent = {g: g for g in parts}
    flat = mask.reshape(-1)
    for r0 in range(0, H, th):
        for c0 in range(0, W, tw):
            pairs = []
            if r0:   # top border; skipped where the left pair joins them
                pairs += [(p, p - W, c > c0 and flat[p - 1] and
                           flat[p - 1 - W])
                          for c in range(c0, min(c0 + tw, W))
                          for p in [r0 * W + c]]
            if c0:   # left border; skipped where the upper pair does
                pairs += [(p, p - 1, r > r0 and flat[p - W] and
                           flat[p - W - 1])
                          for r in range(r0, min(r0 + th, H))
                          for p in [r * W + c0]]
            for p, q, skip in pairs:
                if flat[p] and flat[q] and not skip:
                    _unite(parent, int(lab[p]), int(lab[q]))
    fg = lab < n
    lab[fg] = [_find(parent, int(t)) for t in lab[fg]]

    sums = {}
    for t, p in parts.items():
        row, col = divmod(t, W)
        row0, col0 = row - row % th, col - col % tw
        cnt = _field(p, cc_kernel.PACK_COUNT)
        row_sum = _field(p, cc_kernel.PACK_ROWS) + cnt * row0
        if band:
            row_sum -= band * (cnt * (row0 // band)
                               + _field(p, cc_kernel.PACK_WRAPS))
        s = sums.setdefault(_find(parent, t), [0, 0, 0])
        s[0] += cnt
        s[1] += row_sum
        s[2] += _field(p, cc_kernel.PACK_COLS) + cnt * col0
    roots = np.array(sorted(sums), np.int64)
    table = np.array([sums[r] for r in roots], np.int64).reshape(-1, 3)
    return lab.reshape(H, W), (roots, *table.T)


def _tiled(masks):
    return tile_frames(torch.from_numpy(masks)).numpy(), masks.shape[1] + 1


def _model_case(name):
    """(mask, band) of each case of the tile model's test."""
    if name.startswith("random@"):
        density = float(name.split("@")[1])
        return _random_mask(11, density, (70, 150)), 0
    if name == "spiral":
        return _spiral(33), 0
    if name == "lattice_tiled":
        _, masks, _ = make_lattice_stack(n_images=3, size=64, spacing=12,
                                         seed=1)
        return _tiled(masks > 0)
    if name == "random_tiled":   # frames end inside tiles
        return _tiled(np.random.RandomState(12).rand(5, 23, 71) < 0.5)
    if name == "one_row_frames":  # band 2: every tile wraps 16 times
        return _tiled(np.random.RandomState(13).rand(20, 1, 70) < 0.6)
    shape = {"narrow(33,1)": (33, 1), "narrow(1,130)": (1, 130),
             "narrow(67,2)": (67, 2), "narrow(5,33)": (5, 33),
             "ragged(97,129)": (97, 129)}[name]
    return _random_mask(14, 0.6, shape), 0


@pytest.mark.parametrize("name", [
    "random@0.1", "random@0.5", "random@0.59", "random@0.9", "spiral",
    "lattice_tiled", "random_tiled", "one_row_frames", "narrow(33,1)",
    "narrow(1,130)", "narrow(67,2)", "narrow(5,33)", "ragged(97,129)"])
def test_tile_model_equals_jax(name):
    """The kernel's tile decomposition (tile-local labels, border merge,
    relabel, per-tile partial sums) gives exactly the JAX package's labels
    and moments; so do the port's plain blob sums."""
    mask, band = _model_case(name)
    lab, (roots, counts, row_sums, col_sums) = _tile_model(mask, band)
    ref = np.asarray(jax_cc.label_components(jnp.asarray(mask, jnp.float32)))
    np.testing.assert_array_equal(lab, ref)
    c, r, k = (np.asarray(a) for a in jax_cc._blob_moments(
        jnp.asarray(ref), band=band))
    want_roots = np.nonzero(c[:-1])[0]
    np.testing.assert_array_equal(roots, want_roots)
    for got, want in ((counts, c), (row_sums, r), (col_sums, k)):
        assert np.abs(want).max() < 2 ** 24      # float32 sums are exact
        np.testing.assert_array_equal(got, want[want_roots].astype(np.int64))
    port = blob_sums(torch.from_numpy(mask), band)
    for got, want in zip(port, (roots, counts, row_sums, col_sums)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_blob_sums_dispatch():
    mask = torch.from_numpy(_random_mask(15, 0.5))
    before = _launches()
    for a, b in zip(blob_sums(mask, 7), blob_sums_reference(mask, 7)):
        assert torch.equal(a, b)
    assert _launches() == before
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        blob_sums(mask.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_kernel.blob_sums_cuda(mask)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc_kernel.launch(mask)
