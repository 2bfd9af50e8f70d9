"""SegResNet's training step in the port and in the JAX package, from one
state, in the regime where the card's runs spike.

``scripts/segresnet_spike_trace.py`` traced the spike on the card: the
loss jumps within two cycles after the gradient norm has grown for about
five, led by the Adam updates of the ResModules' convs and BatchNorm
scales; no BatchNorm's batch variance moves first (the smallest, a dead
channel of ``c1`` at 1e-7 with mean -2e-3, stays put, and there the
one-pass variance of flax and the centred one of torch differ by
mean² · 6e-8 ≈ 3e-13), and the biases of the convs that feed a BatchNorm
carry Adam second moments of 1e-26 to 1e-20.
``scripts/segresnet_spike_step.py`` replayed the card's float32 state 20
cycles before its spike in both packages on the CPU (8 frames of each
scheduled batch): both spiked in the same cycle, 0.027 -> 0.067 -> 0.644
(port) and 0.645 (JAX).

Here the port trains a narrow SegResNet on the CPU into that regime (the
pre-BatchNorm biases' second moments at 1e-20 and below, against a median
of about 1e-9), the weights, statistics and Adam moments cross to flax by
the weight bridge, and one step of each package on one batch is compared.
Bounds, float32 on the CPU, from the differences measured here (the loss
6e-6 relative; gradients 1e-2 of each leaf's largest value, the sums of 14
BatchNorms in another order; updates 3e-2, the c1 bias whose channels
include nearly dead ones):
- the loss within 1e-4 relative;
- every gradient within 2e-2 of its leaf's scale, except the pre-BatchNorm
  biases', whose true value is 0 (rounding noise of either sign);
- every Adam update within 5e-2 of its leaf's scale, except those biases,
  whose updates differ by at most 0.05 lr (their second moments are far
  below eps² = 1e-16, so noise moves them by lr · noise / eps), and every
  update within 2 lr (Adam's bound for a flipped sign).
"""
import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from atomai_tpu_torch import models
from atomai_tpu_torch.utils import make_lattice_stack

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import segresnet_spike_step as spike  # noqa: E402

torch.set_num_threads(1)

NB_FILTERS = 8
CYCLES = 200
TOL_LOSS_REL = 1e-4
TOL_GRAD = 2e-2
TOL_UPDATE = 5e-2
TOL_PRE_BN_UPDATE = 0.05 * spike.LR
TOL_ADAM = 2 * spike.LR


@pytest.fixture(scope="module")
def regime(tmp_path_factory):
    imgs, masks, _ = make_lattice_stack(n_images=8, size=64, spacing=8,
                                        seed=0)
    m = models.Segmentor("SegResNet", 1, nb_filters=NB_FILTERS, seed=1,
                         device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        m.fit(imgs, masks, training_cycles=CYCLES, batch_size=4,
              filename=str(tmp_path_factory.mktemp("seg") / "seg"))
    params = [p for _, p in m.net.named_parameters()]
    adam = {i: {k: v.clone() if torch.is_tensor(v) else v
                for k, v in m.optimizer.state[p].items()}
            for i, p in enumerate(params)}
    state = {k: v.clone() for k, v in m.net.state_dict().items()}
    return m, state, adam


def test_the_regime_is_the_traced_one(regime):
    m, _, adam = regime
    names = [k for k, _ in m.net.named_parameters()]
    vmin = {n: float(adam[i]["exp_avg_sq"].min())
            for i, n in enumerate(names)}
    pre_bn = [n for n in names if ".c0." in n and
              n.endswith(("c1.bias", "c2.bias"))]
    assert len(pre_bn) == 12
    assert max(vmin[n] for n in pre_bn) < 1e-18
    assert np.median(list(vmin.values())) > 1e-12
    assert m.loss_acc["train_loss"][-1] < 0.2


def test_one_step_matches_jax_in_the_spike_regime(regime):
    m, state, adam = regime
    X = m.Xb_train[0].numpy()
    y = m.yb_train[0].numpy().astype(np.float32)
    r = spike.compare_step(NB_FILTERS, state, adam, X, y)
    assert abs(r["loss_port"] / r["loss_jax"] - 1) < TOL_LOSS_REL
    assert len(r["grad"]) == len(r["update"]) == len(adam)
    for leaf, err in r["grad"].items():
        if not spike.pre_bn_bias(leaf):
            assert err < TOL_GRAD, (leaf, err)
    for leaf, err in r["update"].items():
        if not spike.pre_bn_bias(leaf):
            assert err < TOL_UPDATE, (leaf, err)
    assert r["pre_bn_update_abs"] < TOL_PRE_BN_UPDATE
    assert r["update_diff_abs"] < TOL_ADAM
