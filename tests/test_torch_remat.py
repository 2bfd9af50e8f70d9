"""``fit(remat=True)`` on the CPU: rematerialisation must not change a
single bit.

From the same weights and generators, a remat fit and a plain fit give
bit-identical losses, weights and BatchNorm running statistics (compared
with ``torch.equal``), for the Unet with dropout and BatchNorm, two zoo
nets (SegResNet's ResModules, dilnet's DilatedBlocks), rVAE and jrVAE
(their decoders on the spatial MLP's plain version, checkpointed) and
``EnsembleTrainer``; each run also shows that the recompute happened (a
block's forward runs twice a step). The JAX package's ``remat=True`` fit
from the same weights stays within the trajectory tolerances that
``tests/test_torch_trainer.py`` states for the plain fit. The unit tests
pin each hazard of a recompute: BatchNorm statistics updated twice, an
explicit generator drawn twice, TF32 switches of the backward, and which
blocks are units.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.utils.checkpoint

import atomai_tpu_torch as aoi
from atomai_tpu_torch.nets import Dropout, checkpointed, set_remat
from atomai_tpu_torch.ops import spatial_mlp as smlp
from atomai_tpu_torch.trainers import EnsembleTrainer
from test_torch_trainer import _assert_same_trajectory, _pair

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _seg_data(seed=3, n=8, size=16):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, size, size).astype(np.float32)
    y = (rng.rand(n, size, size) > 0.6).astype(np.float32)
    return X, y


def _assert_same_state(a: nn.Module, b: nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _count_calls(module: nn.Module):
    calls = [0]

    def hook(*_):
        calls[0] += 1
    module.register_forward_hook(hook)
    return calls


SEG_CASES = {
    "unet_dropout_bn": ("Unet", dict(nb_filters=4, layers=(1, 2, 1, 2),
                                     dropout=True)),
    "segresnet": ("SegResNet", dict(nb_filters=4, layers=(1, 1, 1))),
    "dilnet": ("dilnet", dict(nb_filters=4, layers=(1, 2, 2, 1),
                              dropout=True)),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmentor_remat_fit_is_bit_identical(tmp_path, case):
    model, kw = SEG_CASES[case]
    X, y = _seg_data()
    runs, calls = [], []
    for remat in (False, True):
        m = aoi.models.Segmentor(model, 1, seed=5, device="cpu", **kw)
        calls.append(_count_calls(m.net.c1.block[0]))
        m.fit(X, y, X[:4], y[:4], training_cycles=4, batch_size=4,
              print_loss=4, gauss_noise=[1, 5], swa=True, remat=remat,
              filename=str(tmp_path / f"m{remat}"))
        runs.append(m)
    plain, remat = runs
    assert remat.remat and remat.net.c1.remat and not plain.net.c1.remat
    for k in ("train_loss", "test_loss"):
        assert remat.loss_acc[k] == plain.loss_acc[k], k
    _assert_same_state(plain.net, remat.net)
    assert any(isinstance(m, nn.BatchNorm2d) for m in remat.net.modules())
    # the first block ran again in each of the 4 backward passes (and
    # once more in eval_model's and the 4 test batches' forwards)
    assert calls[1][0] == calls[0][0] + 4
    if kw.get("dropout"):
        assert any(isinstance(m, Dropout) and m.p > 0
                   for m in remat.net.modules())


def test_remat_fit_matches_the_jax_remat_fit(tmp_path):
    """The JAX package's ``fit(remat=True)`` (``jax.checkpoint`` over the
    training forward) and the port's from the same weights: the plain
    fit's tolerances (``tests/test_torch_trainer.py``)."""
    jm, pm = _pair(tmp_path, remat=True, compute_accuracy=True)
    assert jm.remat and pm.remat
    _assert_same_trajectory(jm, pm)


def _vae_data(seed=0, n=24, size=12):
    return np.random.RandomState(seed).rand(n, size, size).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["rVAE", "jrVAE", "VAE"])
def test_vae_remat_fit_is_bit_identical(tmp_path, monkeypatch, kind):
    X = _vae_data()
    kw = dict(numhidden_encoder=16, numhidden_decoder=16, device="cpu",
              seed=4)
    if kind == "jrVAE":
        kw["discrete_dim"] = [3]
    counted = [0]
    plain_ref = smlp.spatial_mlp_reference

    def counting(*args):
        counted[0] += 1
        return plain_ref(*args)
    monkeypatch.setattr(smlp, "spatial_mlp_reference", counting)
    runs, counts = [], []
    for remat in (False, True):
        counted[0] = 0
        m = getattr(aoi.models, kind)((12, 12), **kw)
        m.fit(X, X_test=X[:8], training_cycles=3, batch_size=8,
              remat=remat, filename=str(tmp_path / f"v{remat}"))
        runs.append(m)
        counts.append(counted[0])
    plain, remat = runs
    assert remat.remat and remat.encoder_net.remat and \
        remat.decoder_net.remat
    for k in ("train_loss", "test_loss"):
        assert remat.loss_history[k] == plain.loss_history[k], k
    _assert_same_state(plain.encoder_net, remat.encoder_net)
    _assert_same_state(plain.decoder_net, remat.decoder_net)
    if kind != "VAE":
        # 3 epochs of 3 training batches: the plain version recomputed
        # once in each backward
        assert remat.decoder_net.fused()
        assert counts[1] == counts[0] + 9


def test_ensemble_remat_is_bit_identical(tmp_path):
    X, y = _seg_data(n=12)
    nets = []
    for remat in (False, True):
        et = EnsembleTrainer("Unet", 1, seed=2, device="cpu", nb_filters=4,
                             layers=(1, 1, 1, 1), dropout=True)
        et.compile_ensemble_trainer(training_cycles=3, batch_size=4,
                                    remat=remat,
                                    filename=str(tmp_path / f"e{remat}"))
        net, ens = et.train_ensemble_from_scratch(X, y, X[:4], y[:4],
                                                  n_models=2)
        nets.append((et, net, ens))
    (ep, netp, ensp), (er, netr, ensr) = nets
    assert er.loss_acc["train_loss"] == ep.loss_acc["train_loss"]
    assert netr.c1.remat and not netp.c1.remat
    _assert_same_state(netp, netr)
    for i in ensp:
        for k in ensp[i]:
            assert torch.equal(ensp[i][k], ensr[i][k]), (i, k)


def test_spatial_mlp_checkpointed_on_its_plain_version():
    rng = np.random.RandomState(1)
    B, n, H, L = 3, 20, 16, 2
    shapes = [(B, 2, n), (B, H), (2, H), (1, H), (L, H, H), (L, H), (H, 1),
              (1, 1)]
    grads = []
    for remat in (False, True):
        args = [torch.tensor(rng.randn(*s).astype(np.float32) * 0.5,
                             requires_grad=True) for s in shapes]
        rng = np.random.RandomState(1)
        y = smlp.spatial_mlp(*args, remat=remat)
        (y * torch.linspace(-1, 1, n)).sum().backward()
        grads.append([y.detach()] + [a.grad for a in args])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the hazards
class _Recorder(nn.Module):
    """Conv, BatchNorm, a generator-driven dropout; records the TF32
    switch and the dropout mask of every call."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 2, 3, padding=1)
        self.bn = nn.BatchNorm2d(2)
        self.drop = Dropout(0.5)
        self.flags, self.masks = [], []

    def forward(self, x):
        self.flags.append(torch.backends.cudnn.allow_tf32)
        h = self.bn(self.conv(x))
        out = self.drop(h)
        self.masks.append((out != 0).clone())
        return out


def test_checkpointed_recompute_leaves_no_trace():
    torch.manual_seed(0)
    unit = _Recorder().train()
    g = torch.Generator().manual_seed(7)
    unit.drop.generator = g
    x = torch.randn(4, 1, 8, 8)
    saved = torch.backends.cudnn.allow_tf32
    try:
        # a whole recompute (by default it stops at the last tensor the
        # backward needs, before the recorder's last line)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            torch.backends.cudnn.allow_tf32 = True
            out = checkpointed(unit, unit, x.requires_grad_())
            stats = [b.clone() for b in unit.buffers()]
            after_forward = g.get_state()
            torch.backends.cudnn.allow_tf32 = False
            out.sum().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert len(unit.flags) == 2 and unit.flags == [True, True]
    assert torch.equal(unit.masks[0], unit.masks[1])   # the same draw
    assert torch.equal(g.get_state(), after_forward)   # put back
    for b, s in zip(unit.buffers(), stats):
        assert torch.equal(b, s)                        # stats moved once
    assert int(unit.bn.num_batches_tracked) == 1


def test_set_remat_units():
    net = aoi.nets.Unet(nb_filters=4)
    set_remat(net)
    units = sorted(n for n, m in net.named_modules()
                   if getattr(m, "remat", False))
    assert units == ["bn", "c1", "c2", "c3", "c4", "c5", "c6",
                     "upsample_block1", "upsample_block2",
                     "upsample_block3"]
    set_remat(net, False)
    assert not any(getattr(m, "remat", False) for m in net.modules())
    # a user's module with no unit is one, keeping its name and weights
    custom = nn.Sequential(nn.Conv2d(1, 1, 3, padding=1), nn.ReLU())
    keys = list(custom.state_dict())
    set_remat(custom)
    assert custom.remat and type(custom).__name__ == "Sequential"
    assert isinstance(custom, nn.Sequential)
    assert list(custom.state_dict()) == keys
    x = torch.randn(2, 1, 6, 6, requires_grad=True)
    calls = _count_calls(custom[0])
    custom(x).sum().backward()
    assert calls[0] == 2
    # the VAE decoder on the fused route is its own unit; the encoder too
    enc, dec = aoi.nets.init_VAE_nets((12, 12), 2, coord=3,
                                      numhidden_encoder=16,
                                      numhidden_decoder=16)[:2]
    set_remat(enc)
    set_remat(dec)
    assert enc.remat and dec.remat and dec.fused()


def _plain_fits(*values):
    return [{"x": v} for v in values]


def _dist(a, b):
    return {"x": abs(a["x"] - b["x"])}


@pytest.mark.parametrize("fit, bound, spread_keys, passes", [
    # within the a priori bound of every plain fit
    (0.5, 1.0, (), True),
    # within the bound of one plain fit only: the bound must hold for all
    (0.55, 0.3, (), False),
    # outside the bound, nearest plain fit within 3 times their spread
    # (0.2): an exchangeable fit
    (0.45, 0.01, ("x",), True),
    # the same fit, the spread not taken for this measure
    (0.45, 0.01, (), False),
    # far from every plain fit: 3 * 0.2 < 1.7
    (2.0, 0.01, ("x",), False),
])
def test_hold_to_spread(fit, bound, spread_keys, passes):
    """chip_smoke's hold of a fit against several plain fits: the a
    priori bound against each of them, else (where allowed) the nearest
    one within REMAT_NOISE_FACTOR times the largest distance between two
    plain fits."""
    plains = _plain_fits(0.1, 0.2, 0.3)
    args = ("fit", {"x": fit}, plains, _dist, {"x": bound}, spread_keys)
    if passes:
        held = chip_smoke.hold_to_spread(*args)
        assert held["nearest"]["x"] == pytest.approx(
            min(abs(fit - p["x"]) for p in plains))
        assert held["spread"]["x"] == pytest.approx(0.2)
        assert len(held["vs_plain"]) == 3 and len(held["plain_vs_plain"]) == 3
    else:
        with pytest.raises(AssertionError, match="off the plain fits"):
            chip_smoke.hold_to_spread(*args)
