"""The port's supervised losses and IoU against the JAX package's, on the
same channel-last inputs made with numpy.

Both run in float32 on the CPU; the tolerance (1e-6 relative, 1e-7
absolute) covers the order of float32 sums over a few thousand pixels.
The focal loss gets 4e-6: its factor (1 - exp(-ce))^gamma multiplies the
relative error of the mean cross-entropy by 1 + gamma * ce * pt / (1 - pt),
about 3 at these inputs (ce ~ 1.3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.losses_metrics import losses as jl
from atomai_tpu.losses_metrics import metrics as jm
from atomai_tpu_torch.losses_metrics import losses as tl
from atomai_tpu_torch.losses_metrics import metrics as tm

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
RTOL_FOCAL = 4e-6
SHAPE = (3, 16, 20)


def _inputs(nb_classes, seed=0, scale=3.0):
    """Channel-last logits and labels: a float mask for one class, integer
    labels for several."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*SHAPE, nb_classes) * scale).astype(np.float32)
    if nb_classes == 1:
        labels = (rng.rand(*SHAPE) > 0.5).astype(np.float32)
    else:
        labels = rng.randint(0, nb_classes, SHAPE).astype(np.int32)
    return logits, labels


def _both(fn_j, fn_t, *arrays, **kwargs):
    want = float(fn_j(*[jnp.asarray(a) for a in arrays], **kwargs))
    got = fn_t(*[torch.from_numpy(a) for a in arrays], **kwargs)
    assert got.ndim == 0
    return float(got), want


@pytest.mark.parametrize("name,nb_classes", [
    ("dice", 1), ("dice", 3), ("ce", 1), ("ce", 3), ("focal", 1),
    ("mse", 1)])
def test_select_loss_matches_jax(name, nb_classes):
    logits, labels = _inputs(nb_classes)
    got, want = _both(jl.select_loss(name, nb_classes),
                      tl.select_loss(name, nb_classes), logits, labels)
    rtol = RTOL_FOCAL if name == "focal" else RTOL
    assert got == pytest.approx(want, rel=rtol, abs=ATOL)


@pytest.mark.parametrize("with_logits", [True, False])
@pytest.mark.parametrize("alpha,gamma", [(0.5, 2.0), (0.25, 1.0)])
def test_focal_loss_matches_jax(with_logits, alpha, gamma):
    logits, labels = _inputs(1, seed=1)
    pred = logits if with_logits else 1 / (1 + np.exp(-logits))
    got, want = _both(jl.focal_loss, tl.focal_loss, pred, labels,
                      alpha=alpha, gamma=gamma, with_logits=with_logits)
    assert got == pytest.approx(want, rel=RTOL_FOCAL, abs=ATOL)


def test_focal_loss_modulates_the_mean():
    """The JAX package's quirk: the factor (1 - exp(-ce))^gamma uses the
    mean cross-entropy, not each pixel's."""
    logits, labels = _inputs(1, seed=2)
    ce = float(tl._bce_with_logits(torch.from_numpy(logits[..., 0]),
                                   torch.from_numpy(labels)))
    got = float(tl.focal_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    assert got == pytest.approx(0.5 * (1 - np.exp(-ce)) ** 2 * ce, rel=1e-6)


@pytest.mark.parametrize("scale", [0.1, 30.0])
def test_bce_with_logits_matches_jax(scale):
    """Stable at large |logits| too."""
    logits, labels = _inputs(1, seed=3, scale=scale)
    for reduction in ("mean", "none"):
        want = np.asarray(jl._bce_with_logits(jnp.asarray(logits[..., 0]),
                                              jnp.asarray(labels),
                                              reduction))
        got = tl._bce_with_logits(torch.from_numpy(logits[..., 0]),
                                  torch.from_numpy(labels), reduction)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nb_classes", [2, 4])
def test_ce_and_nll_match_jax(nb_classes):
    logits, labels = _inputs(nb_classes, seed=4)
    got, want = _both(jl.ce_loss, tl.ce_loss, logits, labels)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    logp = np.asarray(torch.log_softmax(torch.from_numpy(logits), -1))
    got, want = _both(jl.nll_loss, tl.nll_loss, logp, labels)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)


def test_mse_matches_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(4, 7, 1).astype(np.float32)
    target = rng.randn(4, 7).astype(np.float32)
    got, want = _both(jl.mse_loss, tl.mse_loss, pred, target)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    got, want = _both(jl.mse_loss, tl.mse_loss, pred[..., 0], target)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("name,weights", [("multitask_nll", None),
                                          ("multitask_ce", [0.3, 1.5])])
def test_multitask_matches_jax(name, weights):
    outs, labs = [], []
    for k, nb in enumerate((2, 3)):
        logits, labels = _inputs(nb, seed=10 + k)
        if name == "multitask_nll":
            logits = np.asarray(torch.log_softmax(torch.from_numpy(logits),
                                                  -1))
        outs.append(logits)
        labs.append(labels)
    want = float(jl.select_loss(name, [2, 3], weights=weights)(
        [jnp.asarray(o) for o in outs], [jnp.asarray(lab) for lab in labs]))
    got = float(tl.select_loss(name, [2, 3], weights=weights)(
        [torch.from_numpy(o) for o in outs],
        [torch.from_numpy(lab) for lab in labs]))
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    direct = float(tl.MultiTaskLoss(2, tl.nll_loss if name ==
                                    "multitask_nll" else tl.ce_loss,
                                    weights)(
        [torch.from_numpy(o) for o in outs],
        [torch.from_numpy(lab) for lab in labs]))
    assert direct == pytest.approx(got, rel=1e-7)


def test_select_loss_contract():
    def custom(logits, labels):
        return logits.sum()
    assert tl.select_loss(custom) is custom
    with pytest.raises(ValueError, match="number of classes"):
        tl.select_loss("ce")
    with pytest.raises(ValueError, match="for each task"):
        tl.select_loss("multitask_ce", 3)
    with pytest.raises(NotImplementedError):
        tl.select_loss("hinge", 1)
    with pytest.raises(ValueError, match="num_tasks"):
        tl.MultiTaskLoss(2, weights=[1.0])


@pytest.mark.parametrize("nb_classes", [1, 3])
@pytest.mark.parametrize("activation", [True, False])
def test_iou_score_matches_jax(nb_classes, activation):
    logits, labels = _inputs(nb_classes, seed=6)
    pred = logits if activation else 1 / (1 + np.exp(-logits))
    got, want = _both(jm.iou_score, tm.iou_score, labels, pred,
                      activation=activation)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert tm.IoU(torch.from_numpy(labels), torch.from_numpy(pred),
                  activation).evaluate() == pytest.approx(got, rel=1e-7)


def test_iou_score_edge_cases_match_jax():
    """A perfect prediction scores 1; a class absent from both the truth
    and the prediction is left out of the mean; labels out of range are
    ignored."""
    labels = np.zeros((2, 8, 8), np.int32)
    labels[:, :4] = 1
    perfect = np.where(labels[..., None] == np.arange(3), 5.0,
                       -5.0).astype(np.float32)
    got, want = _both(jm.iou_score, tm.iou_score, labels, perfect)
    assert got == pytest.approx(want) == pytest.approx(1.0)
    labels[0, 0, 0] = 7
    got, want = _both(jm.iou_score, tm.iou_score, labels, perfect)
    assert got == pytest.approx(want, rel=RTOL)
