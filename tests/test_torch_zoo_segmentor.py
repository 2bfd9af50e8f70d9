"""The new segmentation nets through the port's facades, against the JAX
package's: ``Segmentor(<net>).fit`` from the same weights (carried by
``fcnn_from_jax``) on the same lattice frames and batch schedule, then
``predict`` and the Locator on the JAX-trained weights, for dilnet,
SegResNet, ResHedNet and the dilated Unet; a short
``EnsembleTrainer("SegResNet")`` run from one baseline; a user's
``nn.Module`` as the Segmentor's net.

Stated tolerances, float32 on the CPU:
- three Adam(1e-3) cycles: the first train loss (the same weights, train
  mode) 1e-4 relative; weights within 2 * lr * steps (Adam moves a weight
  by lr a step whatever its gradient's size, and a rounding-size gradient
  may take the other sign in the other package); the later losses and the
  running statistics, which those weights move, 1e-2 relative (the
  running means and variances over their largest |value|; the running
  variances also differ by n / (n - 1), n >= 4 x 4 x 4 here: flax's biased
  update against torch's unbiased one). Measured: first losses <= 1.4e-6,
  later train losses 1.4e-6, test losses 4.0e-4, weights 3.1e-3 (of the
  6e-3 bound), running statistics 2.9e-3 (ResHedNet);
- ``predict`` on the same weights: maps 1e-5 absolute; coordinates the
  same frames and counts within 1e-4 px, at a threshold in the widest gap
  between map values near the 80th percentile, wider than the two
  packages' difference (every pixel then falls on the same side in both).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models import Segmentor as JaxSegmentor
from atomai_tpu.trainers import EnsembleTrainer as JaxEnsembleTrainer
from atomai_tpu.trainers.trainer import _shuffled_batch_schedule
from atomai_tpu_torch.models import (Segmentor, ensemble_from_jax,
                                     fcnn_from_jax, load_ensemble,
                                     load_model)
from atomai_tpu_torch.trainers import EnsembleTrainer
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

LR, CYCLES = 1e-3, 3
TOL_ADAM = 2 * LR * CYCLES
RTOL_FIRST_LOSS = 1e-4
RTOL_ADAM = 1e-2
ATOL_MAPS = 1e-5
TOL_PX = 1e-4
NETS = {
    "dilnet": ("dilnet", dict(nb_filters=4, layers=[1, 2, 2, 1])),
    "SegResNet": ("SegResNet", dict(nb_filters=4, layers=[1, 1, 1])),
    "ResHedNet": ("ResHedNet", dict(nb_filters=4, layers=[1, 1, 2])),
    "Unet_dilated": ("Unet", dict(nb_filters=4, layers=[1, 1, 1, 2],
                                  with_dilation=True)),
}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _gap_threshold(maps, q=0.8, window=2000):
    """The midpoint of the widest gap between distinct map values around
    the ``q`` quantile, and the gap's width."""
    v = np.unique(maps)
    i = int(q * len(v))
    lo, hi = max(i - window, 0), min(i + window, len(v) - 1)
    gaps = np.diff(v[lo:hi + 1])
    j = lo + int(np.argmax(gaps))
    return float((v[j] + v[j + 1]) / 2), float(gaps.max())


def _seeded(jnet, x):
    script = chip_smoke.fixture_script()
    v = script.seeded_variables(script.variable_shapes(jnet, x))
    return script.unflatten(v, "params"), script.unflatten(v, "batch_stats")


def _assert_state_close(got, want):
    """Weights within 2 * lr * steps, running statistics 1e-2 relative."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((got[k] - w).abs().max())
        if k.endswith(("running_mean", "running_var")):
            assert err <= RTOL_ADAM * float(w.abs().max()), (k, err)
        else:
            assert err <= TOL_ADAM, (k, err)


@pytest.fixture(scope="module", params=sorted(NETS))
def fitted(request, tmp_path_factory):
    """(JAX Segmentor, port Segmentor) trained from the same weights."""
    model, kw = NETS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    imgs, masks, _ = make_lattice_stack(n_images=10, size=32, spacing=8,
                                        seed=1)
    jm = JaxSegmentor(model, 1, seed=7, **kw)
    jm.params, jm.batch_stats = _seeded(jm.net, imgs[:1, ..., None])
    pm = Segmentor(model, 1, seed=7, device="cpu", **kw)
    pm.load_jax_variables(jm.params, jm.batch_stats)
    fit = dict(training_cycles=CYCLES, batch_size=4, print_loss=CYCLES,
               compute_accuracy=True)
    jm.fit(imgs[:8], masks[:8], imgs[8:], masks[8:],
           filename=str(tmp / "j"), mesh=False, **fit)
    pm.fit(imgs[:8], masks[:8], imgs[8:], masks[8:],
           filename=str(tmp / "p"), **fit)
    return request.param, jm, pm


def test_fit_matches_jax(fitted):
    name, jm, pm = fitted
    assert pm.meta_state_dict == jm.meta_state_dict
    np.testing.assert_array_equal(pm.batch_idx_train, jm.batch_idx_train)
    got, want = pm.loss_acc["train_loss"], jm.loss_acc["train_loss"]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL_FIRST_LOSS)
    np.testing.assert_allclose(got, want, rtol=RTOL_ADAM)
    np.testing.assert_allclose(pm.loss_acc["test_loss"],
                               jm.loss_acc["test_loss"], rtol=RTOL_ADAM)
    assert len(pm.loss_acc["test_accuracy"]) == CYCLES
    _assert_state_close(pm.net.state_dict(), fcnn_from_jax(
        _np(jm.params), _np(jm.batch_stats), pm.meta_state_dict))


def test_predict_and_locate_match_jax_on_the_trained_weights(fitted):
    """The JAX-trained variables loaded into a fresh port Segmentor: maps
    and coordinates of ``predict`` (the Locator's labeller runs its plain
    version on the CPU), frames padded to the net's downsample factor."""
    name, jm, _ = fitted
    model, kw = NETS[name]
    pm = Segmentor(model, 1, seed=3, device="cpu", **kw)
    pm.load_jax_variables(_np(jm.params), _np(jm.batch_stats))
    imgs, _, _ = make_lattice_stack(n_images=6, size=60, spacing=12, seed=2)
    jax_maps = jm.predict(imgs, compute_coords=False, verbose=False)
    maps = pm.predict(imgs, compute_coords=False, verbose=False)
    pad = {"dilnet": 60, "SegResNet": 60, "ResHedNet": 60, "Unet": 64}
    assert maps.shape == jax_maps.shape == (6, pad[model], pad[model], 1)
    np.testing.assert_allclose(maps, jax_maps, atol=ATOL_MAPS)
    thresh, gap = _gap_threshold(jax_maps)
    assert gap / 2 > 5 * float(np.abs(maps - jax_maps).max())
    _, ref = jm.predict(imgs, thresh=thresh, verbose=False)
    _, coords = pm.predict(imgs, thresh=thresh, verbose=False)
    assert sorted(coords) == sorted(ref) == list(range(6))
    assert sum(len(c) for c in ref.values()) > 0
    for k in ref:
        assert coords[k].shape == ref[k].shape, k
        np.testing.assert_allclose(coords[k], ref[k], atol=TOL_PX)


def test_save_model_load_model_round_trip(fitted, tmp_path):
    name, _, pm = fitted
    path = pm.save_model(str(tmp_path / name))
    m2 = load_model(path, device="cpu")
    assert type(m2.net) is type(pm.net)
    assert m2.meta_state_dict == pm.meta_state_dict
    for a, b in zip(pm.net.state_dict().values(),
                    m2.net.state_dict().values()):
        assert torch.equal(a, b)


def test_ensemble_trainer_segresnet_matches_jax(tmp_path):
    """Two members fine-tuned for three cycles from one baseline
    (``train_ensemble_from_baseline``): schedules, mean losses, each
    member's state; the ensemble file reloads."""
    imgs, masks, _ = make_lattice_stack(n_images=12, size=32, spacing=8,
                                        seed=2)
    x, y, xt, yt = imgs[:10], masks[:10], imgs[10:], masks[10:]
    kw = dict(nb_filters=4, layers=[1, 1, 1])
    jet = JaxEnsembleTrainer("SegResNet", 1, **kw)
    base, _ = _seeded(jet.net, x[:1, ..., None])
    # members take the trainer's own BatchNorm statistics: a fresh net's
    stats = chip_smoke.identity_stats(base)
    jet.params, jet.batch_stats = base, stats
    with jax.default_matmul_precision("highest"):
        jet.compile_ensemble_trainer(batch_size=4, mesh=False,
                                     filename=str(tmp_path / "j"))
        jet.train_ensemble_from_baseline(x, y, xt, yt, basemodel=base,
                                         n_models=2,
                                         training_cycles_ensemble=CYCLES)
    et = EnsembleTrainer("SegResNet", 1, device="cpu", **kw)
    et.compile_ensemble_trainer(batch_size=4, filename=str(tmp_path / "p"))
    net, ens = et.train_ensemble_from_baseline(
        x, y, xt, yt, basemodel=fcnn_from_jax(base, stats,
                                              et.meta_state_dict),
        n_models=2, training_cycles_ensemble=CYCLES)
    assert et.meta_state_dict == jet.meta_state_dict
    np.testing.assert_array_equal(et.member_schedules, [
        _shuffled_batch_schedule(2, CYCLES, i + 2) for i in range(2)])
    np.testing.assert_allclose(et.loss_acc["train_loss"][0],
                               jet.loss_acc["train_loss"][0],
                               rtol=RTOL_FIRST_LOSS)
    np.testing.assert_allclose(et.loss_acc["train_loss"],
                               jet.loss_acc["train_loss"], rtol=RTOL_ADAM)
    want = ensemble_from_jax(_np(jet.ensemble_state_dict),
                             et.meta_state_dict)
    assert sorted(ens) == sorted(want) == [0, 1]
    for i in want:
        _assert_state_close(ens[i], want[i])
    net2, ens2 = load_ensemble(str(tmp_path / "p_ensemble_metadict.aoit"),
                               device="cpu")
    assert type(net2).__name__ == "SegResNet"
    assert all(torch.equal(ens[1][k], ens2[1][k]) for k in ens[1])


class _TinyNet(torch.nn.Module):
    """A user's segmentation net: NCHW images to NCHW logits."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.px = torch.nn.Conv2d(4, 1, 1)

    def forward(self, x):
        return self.px(torch.relu(self.conv(x)))


def test_segmentor_takes_a_custom_module(tmp_path):
    """The module keeps its own weights, trains, predicts and locates;
    ``load_model`` cannot rebuild it from the metadict, ``load_weights``
    loads into it."""
    imgs, masks, _ = make_lattice_stack(n_images=8, size=32, spacing=8,
                                        seed=3)
    net = _TinyNet()
    w0 = net.conv.weight.detach().clone()
    m = Segmentor(net, 1, device="cpu")
    assert m.net is net and torch.equal(net.conv.weight, w0)
    assert m.meta_state_dict == {"model_type": "seg", "model": "custom",
                                 "nb_classes": 1}
    m.fit(imgs, masks, training_cycles=2, batch_size=4, print_loss=2,
          filename=str(tmp_path / "custom"))
    assert not torch.equal(net.conv.weight, w0)
    maps, coords = m.predict(imgs, verbose=False)
    assert maps.shape == (8, 32, 32, 1) and sorted(coords) == list(range(8))
    path = m.save_model(str(tmp_path / "saved"))
    with pytest.raises(NotImplementedError, match="custom module"):
        load_model(path, device="cpu")
    m2 = Segmentor(_TinyNet(), 1, device="cpu")
    m2.load_weights(path)
    np.testing.assert_array_equal(
        m2.predict(imgs, compute_coords=False, verbose=False), maps)
