"""The slice as a whole: the port's ``Segmentor.predict`` with a JAX Unet's
variables loaded, against ``atomai_tpu``'s ``SegPredictor(...).run`` on the
same images.

Maps: float32, atol 1e-5. Coordinates: same frames and counts, atol 1e-4
px. Random weights leave many pixels near any threshold, so the test
thresholds in the widest gap between map values near the 80th percentile,
and checks that the gap is wider than the two packages' difference: their
masks then agree on every pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.nets import Unet as JaxUnet
from atomai_tpu.predictors import SegPredictor as JaxSegPredictor
from atomai_tpu_torch.models import Segmentor
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

ATOL_MAPS = 1e-5
TOL_PX = 1e-4


def _gap_threshold(maps, q=0.8, window=2000):
    """The midpoint of the widest gap between distinct map values around
    the ``q`` quantile, and the gap's width."""
    v = np.unique(maps)
    i = int(q * len(v))
    lo, hi = max(i - window, 0), min(i + window, len(v) - 1)
    gaps = np.diff(v[lo:hi + 1])
    j = lo + int(np.argmax(gaps))
    return float((v[j] + v[j + 1]) / 2), float(gaps.max())


@pytest.fixture(scope="module")
def jax_unet():
    jnet = JaxUnet(nb_classes=1, nb_filters=16, layers=(1, 2, 2, 3))
    v = jax.device_get(jnet.init({"params": jax.random.key(5)},
                                 jnp.zeros((1, 16, 16, 1)), False))
    rng = np.random.RandomState(5)
    stats = jax.tree.map(
        lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32),
        dict(v["batch_stats"]))
    return jnet, jax.tree.map(np.asarray, dict(v["params"])), stats


def test_segmentor_predict_matches_jax(jax_unet):
    jnet, params, stats = jax_unet
    imgs, _, _ = make_lattice_stack(n_images=10, size=64, spacing=12, seed=1)
    jpred = JaxSegPredictor(jnet, params, stats, nb_classes=1, verbose=False)
    m = Segmentor("Unet", nb_classes=1, nb_filters=16, layers=(1, 2, 2, 3),
                  device="cpu")
    m.load_jax_variables(params, stats)
    jax_maps = jpred.predict(imgs)
    diff = np.abs(m.predict(imgs, compute_coords=False, verbose=False)
                  - jax_maps).max()
    thresh, gap = _gap_threshold(jax_maps)
    assert gap / 2 > 5 * diff  # every pixel on the same side in both

    ref_maps, ref_coords = jpred.run(imgs, thresh=thresh)
    maps, coords = m.predict(imgs, thresh=thresh, verbose=False)

    assert maps.shape == ref_maps.shape == (10, 64, 64, 1)
    np.testing.assert_allclose(maps, ref_maps, atol=ATOL_MAPS)
    assert sorted(coords) == sorted(ref_coords) == list(range(10))
    n_atoms = 0
    for k in ref_coords:
        assert coords[k].shape == ref_coords[k].shape, k
        np.testing.assert_allclose(coords[k], ref_coords[k], atol=TOL_PX)
        n_atoms += len(coords[k])
    assert n_atoms > 0


def test_segmentor_seeded_weights_are_reproducible():
    imgs, _, _ = make_lattice_stack(n_images=2, size=32, spacing=8, seed=2)
    kw = dict(nb_filters=4, layers=(1, 1, 1, 1), device="cpu")
    a = Segmentor("Unet", 1, seed=3, **kw)
    b = Segmentor("Unet", 1, seed=3, **kw)
    c = Segmentor("Unet", 1, seed=4, **kw)
    for (k, x), y in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.net.c1.block[0].weight, c.net.c1.block[0].weight)
    maps = a.predict(imgs, compute_coords=False, verbose=False)
    assert maps.shape == (2, 32, 32, 1)
    assert np.isfinite(maps).all() and (maps >= 0).all() and (maps <= 1).all()


def test_segmentor_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Segmentor("Unet", 1, device="cuda")


def test_segmentor_unported_options_raise():
    """The options that raised before the rest of the zoo was ported now
    build, and record the JAX package's metadict."""
    from atomai_tpu.nets import init_fcnn_model as jax_init_fcnn_model
    for model, kw in (("dilnet", {}), ("Unet", {"with_dilation": True})):
        m = Segmentor(model, 1, device="cpu", **kw)
        assert m.meta_state_dict == jax_init_fcnn_model(model, 1, **kw)[1]
    assert type(m.net.bn).__name__ == "DilatedBlock"
