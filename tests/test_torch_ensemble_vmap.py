"""The ensemble trainer's "vmap" member layout (``member_layout="vmap"``):
every member's step as one ``torch.func.vmap`` over the stacked members,
held against the port's "map" loop and against the JAX package's "vmap"
layout; and ``nets/functional_bn.py``'s BatchNorm against ``nn.BatchNorm``.

Bounds, float32 on the CPU:
- "vmap" against "map": the first losses within 1e-5 relative, stated
  before the first run (the same function; vmap's grouped convs and the
  elementwise BatchNorm sum in another order: 3e-7 measured), the rest of
  the losses within ``RTOL_LOSS`` and the members within the states'
  bounds of ``tests/test_torch_ensemble.py`` (2 * lr * steps on weights,
  as a conv bias before a BatchNorm moves by lr a step on rounding noise;
  1e-2 relative on running variances);
- "vmap" against the JAX package's "vmap": as ``test_torch_ensemble.py``
  holds the loop to it;
- the functional BatchNorm against ``nn.BatchNorm1d/2d`` in train mode:
  outputs within 1e-5 (float32) and one bf16 rounding (bf16 output), a
  near-constant channel's within 1e-3, running statistics within 1e-6
  relative, ``num_batches_tracked`` equal.
"""

import contextlib
import copy
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from atomai_tpu.trainers import EnsembleTrainer as JaxEnsembleTrainer
from atomai_tpu_torch.models import (ensemble_from_jax, signal_ed_from_jax,
                                     unet_from_jax)
from atomai_tpu_torch.core import Precision
from atomai_tpu_torch.nets.functional_bn import (MaskedDropout,
                                                 VmapBatchNorm,
                                                 autocast_in_vmap, vmappable)
from atomai_tpu_torch.trainers import EnsembleTrainer
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

RTOL_LOSS = 1e-3
FIRST_LOSS_REL = 1e-5
LR = 1e-3


def _seg_data():
    imgs, masks, _ = make_lattice_stack(n_images=12, size=32, spacing=8,
                                        seed=2)
    return imgs[:10], masks[:10], imgs[10:], masks[10:]


def _train(layout, make, compile_kw, strategy, *args, **kw):
    et = make()
    et.compile_ensemble_trainer(member_layout=layout, **compile_kw)
    with contextlib.redirect_stdout(io.StringIO()):
        net, ens = getattr(et, strategy)(*args, **kw)
    return et, net, ens


def _both(make, compile_kw, strategy, *args, **kw):
    return {layout: _train(layout, make, compile_kw, strategy, *args, **kw)
            for layout in ("map", "vmap")}


def _assert_layouts_agree(runs, cycles):
    (em, nm, sm), (ev, nv, sv) = runs["map"], runs["vmap"]
    if em.member_schedules is not None:
        np.testing.assert_array_equal(ev.member_schedules,
                                      em.member_schedules)
    lm, lv = (np.asarray(e.loss_acc["train_loss"]) for e in (em, ev))
    assert lm.shape == lv.shape
    assert abs(lv[0] / lm[0] - 1) < FIRST_LOSS_REL
    np.testing.assert_allclose(lv, lm, rtol=RTOL_LOSS)
    assert sorted(sv) == sorted(sm)
    for i in sm:
        assert sv[i].keys() == sm[i].keys()
        errs, tols = {}, {}
        chip_smoke.state_errors(sv[i], sm[i], 2 * LR * cycles, errs, tols)
        assert not chip_smoke.failures(errs, tols), (i, errs)
        for k, v in sm[i].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(sv[i][k], v), (i, k)
    for (k, pm), pv in zip(nm.state_dict().items(),
                           nv.state_dict().values()):
        assert pv.shape == pm.shape, k


def _unet(**kw):
    return lambda: EnsembleTrainer("Unet", 1, nb_filters=4,
                                   layers=(1, 1, 1, 1), device="cpu",
                                   seed=3, **kw)


# ------------------------------------------------------ functional BN
@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functional_batch_norm_matches_torch(ndim, dtype):
    g = torch.Generator().manual_seed(ndim)
    shape = (6, 5, 7) if ndim == 1 else (6, 5, 7, 3)
    x = torch.randn(shape, generator=g)
    # a near-constant channel with a large mean (variance 1e-6 below eps):
    # E[x^2] - E[x]^2 would lose it (mean^2 * 6e-8 = 6e-6), the centred
    # variance keeps it; the outputs then differ by the float32 rounding
    # of the mean over the standard deviation, 1e-6 / 3e-3
    x[:, 2] = 10.0 + 1e-3 * x[:, 2]
    bn = (nn.BatchNorm1d if ndim == 1 else nn.BatchNorm2d)(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    ours = VmapBatchNorm(copy.deepcopy(bn))
    swapped = vmappable(nn.Sequential(nn.BatchNorm1d(2), nn.Dropout(0.1)))
    assert [type(m) for m in swapped] == [VmapBatchNorm, MaskedDropout]
    x = x.to(dtype)
    for step in range(2):
        want, got = bn(x), ours(x)
        assert got.dtype == want.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        rest = [0, 1, 3, 4]
        torch.testing.assert_close(got[:, rest].float(),
                                   want[:, rest].float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(got[:, 2].float(), want[:, 2].float(),
                                   rtol=0, atol=max(tol, 1e-3))
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(ours, name),
                                       getattr(bn, name), rtol=1e-6,
                                       atol=1e-7)
        assert int(ours.num_batches_tracked) == step + 1 == \
            int(bn.num_batches_tracked)
    bn.eval(), ours.eval()
    torch.testing.assert_close(ours(x).float(), bn(x).float(), rtol=2e-2,
                               atol=2e-2 if dtype == torch.bfloat16
                               else 1e-5)


def test_functional_batch_norm_under_vmap_moves_each_members_stats():
    bn = VmapBatchNorm(nn.BatchNorm2d(3))
    x = torch.randn(4, 2, 3, 5, 5)
    stacked = {k: torch.stack([v.clone()] * 4) for k, v in
               bn.named_buffers()}
    params = {k: torch.stack([v.detach()] * 4) for k, v in
              bn.named_parameters()}
    out = torch.func.vmap(lambda p, b, xx: torch.func.functional_call(
        bn, (p, b), (xx,)))(params, stacked, x)
    for i in range(4):
        ref = nn.BatchNorm2d(3)
        torch.testing.assert_close(out[i], ref(x[i]), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(stacked["running_var"][i],
                                   ref.running_var)
    assert stacked["num_batches_tracked"].tolist() == [1] * 4


def test_autocast_reaches_the_vmapped_convs():
    """Under autocast a vmapped conv runs in float32 unless
    ``autocast_in_vmap`` applies autocast's casts; an autocast-disabled
    region (a float32 head) stays float32."""
    conv = nn.Conv2d(3, 4, 3, padding=1)
    p = {k: torch.stack([v.detach()] * 2) for k, v in
         conv.named_parameters()}
    x = torch.randn(2, 5, 3, 8, 8)
    step = torch.func.vmap(lambda pp, xx: torch.func.functional_call(
        conv, pp, (xx,)))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert step(p, x).dtype == torch.float32
        with autocast_in_vmap():
            out = step(p, x)
            with torch.autocast("cpu", enabled=False):
                assert step(p, x).dtype == torch.float32
        want = conv(x[1])
    assert out.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(out[1].float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -6)


def test_vmap_matches_map_under_the_bf16_policy(tmp_path):
    """The mixed policy (bf16 autocast) in both layouts: the same first
    loss within bf16's rounding (1e-3 relative)."""
    x, y, xt, yt = _seg_data()

    def make():
        et = _unet()()
        et.precision = Precision.mixed()
        return et
    runs = _both(make, dict(batch_size=4, training_cycles=2,
                            filename=str(tmp_path / "m")),
                 "train_ensemble_from_scratch", x, y, xt, yt, n_models=2)
    lm, lv = (np.asarray(runs[k][0].loss_acc["train_loss"])
              for k in ("map", "vmap"))
    assert abs(lv[0] / lm[0] - 1) < 1e-3


def test_masked_dropout_takes_the_given_mask():
    drop = MaskedDropout(nn.Dropout(0.25))
    x = torch.ones(2, 8)
    with pytest.raises(RuntimeError, match="mask"):
        drop(x)
    drop.mask = torch.rand(2, 8) >= 0.25
    torch.testing.assert_close(drop(x), drop.mask.float() / 0.75)
    assert "mask" not in drop.state_dict()
    assert torch.equal(drop.eval()(x), x)


# ----------------------------------------------------- vmap against map
def test_vmap_matches_map_from_scratch(tmp_path):
    x, y, xt, yt = _seg_data()
    runs = _both(_unet(), dict(batch_size=4, training_cycles=5, swa=True,
                               filename=str(tmp_path / "s")),
                 "train_ensemble_from_scratch", x, y, xt, yt, n_models=3)
    _assert_layouts_agree(runs, 5)
    et, net, ens = runs["vmap"]
    assert len(et.loss_acc["train_loss"]) == 5
    assert not torch.equal(ens[0]["c1.block.0.weight"],
                           ens[1]["c1.block.0.weight"])
    for k, v in net.state_dict().items():
        assert torch.equal(v, ens[2][k]), k
    # the same seed, the same members, bit for bit
    again = _train("vmap", _unet(), dict(
        batch_size=4, training_cycles=5, swa=True,
        filename=str(tmp_path / "s2")), "train_ensemble_from_scratch",
        x, y, xt, yt, n_models=3)[2]
    for i in ens:
        for k, v in ens[i].items():
            assert torch.equal(v, again[i][k]), (i, k)


def test_vmap_matches_map_from_baseline_with_augmentation(tmp_path):
    from atomai_tpu_torch.transforms import seg_augmentor
    x, y, xt, yt = _seg_data()
    base = _unet()().net.state_dict()
    aug = seg_augmentor(1, gauss_noise=[10, 30], rotation=True)
    runs = _both(_unet(), dict(batch_size=4, filename=str(tmp_path / "b")),
                 "train_ensemble_from_baseline", x, y, xt, yt,
                 basemodel=base, n_models=2, training_cycles_ensemble=4,
                 augment_fn=aug)
    _assert_layouts_agree(runs, 4)
    (_, nm, _), (_, nv, sv) = runs["map"], runs["vmap"]
    for k, p in nv.named_parameters():     # the members' mean
        torch.testing.assert_close(
            p.detach(), sum(s[k] for s in sv.values()) / 2, rtol=0,
            atol=1e-7)


def test_swag_runs_under_the_vmap_layout(tmp_path):
    """SWAG has no member axis: one baseline fit, the same in both
    layouts, bit for bit."""
    x, y, xt, yt = _seg_data()
    runs = _both(_unet(), dict(batch_size=4, training_cycles=6,
                               filename=str(tmp_path / "w")),
                 "train_swag", x, y, xt, yt, n_models=3)
    (_, _, sm), (ev, _, sv) = runs["map"], runs["vmap"]
    assert ev.kdict["member_layout"] == "vmap" and sorted(sv) == [0, 1, 2]
    for i in sm:
        for k, v in sm[i].items():
            assert torch.equal(sv[i][k], v), (i, k)


def test_vmap_matches_map_imspec_and_custom_tasks(tmp_path):
    rng = np.random.RandomState(0)
    X, y = rng.rand(12, 16, 16).astype(np.float32), \
        rng.rand(12, 16).astype(np.float32)
    signal = dict(in_dim=(16, 16), out_dim=(16,), latent_dim=2,
                  nblayers_encoder=2, nblayers_decoder=2,
                  nbfilters_encoder=4, nbfilters_decoder=4)
    runs = _both(lambda: EnsembleTrainer("imspec", device="cpu", **signal),
                 dict(batch_size=4, loss="mse", training_cycles=4,
                      filename=str(tmp_path / "i")),
                 "train_ensemble_from_scratch", X[:8], y[:8], X[8:], y[8:],
                 n_models=2)
    assert any(isinstance(m, nn.BatchNorm1d)
               for m in runs["vmap"][1].modules())
    _assert_layouts_agree(runs, 4)

    Xc = rng.rand(24, 6).astype(np.float32)
    yc = (Xc @ rng.rand(6, 2)).astype(np.float32)

    def custom():
        torch.manual_seed(0)
        return EnsembleTrainer(nn.Sequential(
            nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 2)), device="cpu")
    runs = _both(custom, dict(batch_size=6, training_cycles=4, loss="mse",
                              filename=str(tmp_path / "c")),
                 "train_ensemble_from_scratch", Xc[:18], yc[:18], Xc[18:],
                 yc[18:], n_models=2)
    assert runs["vmap"][0]._task == "custom"
    _assert_layouts_agree(runs, 4)


def test_vmap_dropout_draws_each_members_masks(tmp_path):
    """A Unet with dropout: the masks come from each member's generator,
    drawn outside the vmap in the loop's order, so the layouts agree;
    one mask for every member, or none, would not."""
    x, y, xt, yt = _seg_data()
    kw = dict(batch_size=4, training_cycles=4, filename=str(tmp_path / "d"))
    runs = _both(_unet(dropout=True), kw, "train_ensemble_from_scratch",
                 x, y, xt, yt, n_models=2)
    assert any(isinstance(m, nn.Dropout) and m.p > 0
               for m in runs["map"][1].modules())
    _assert_layouts_agree(runs, 4)
    plain = _train("vmap", _unet(), kw, "train_ensemble_from_scratch",
                   x, y, xt, yt, n_models=2)[0]
    assert plain.loss_acc["train_loss"][0] != \
        runs["vmap"][0].loss_acc["train_loss"][0]


def _saved_bytes(et, x, y, xt, yt):
    """Bytes that autograd keeps for the backward in a step of a
    vmap-layout fit (the fit's total over its cycles)."""
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with contextlib.redirect_stdout(io.StringIO()):
            et.train_ensemble_from_scratch(x, y, xt, yt, n_models=2)
    return kept[0] / et.kdict["training_cycles"]


def test_vmap_with_remat_equals_vmap_and_keeps_less(tmp_path):
    x, y, xt, yt = _seg_data()
    kw = dict(batch_size=4, training_cycles=3, filename=str(tmp_path / "r"))
    runs = {remat: _train("vmap", _unet(dropout=True),
                          dict(kw, remat=remat),
                          "train_ensemble_from_scratch", x, y, xt, yt,
                          n_models=2) for remat in (False, True)}
    assert runs[True][0].loss_acc["train_loss"] == \
        runs[False][0].loss_acc["train_loss"]
    for i, s in runs[False][2].items():
        for k, v in s.items():
            assert torch.equal(runs[True][2][i][k], v), (i, k)
    kept = {}
    for remat in (False, True):
        et = _unet()()
        et.compile_ensemble_trainer(member_layout="vmap", remat=remat, **kw)
        kept[remat] = _saved_bytes(et, x, y, xt, yt)
    assert kept[True] < 0.6 * kept[False], kept     # 0.39 measured


def test_vmap_takes_only_elementwise_optimizers(tmp_path):
    x, y, xt, yt = _seg_data()
    for opt in ("sgd", "adamw", lambda p: torch.optim.SGD(p, lr=1e-2,
                                                          momentum=0.9)):
        _train("vmap", _unet(), dict(batch_size=4, training_cycles=2,
                                     optimizer=opt,
                                     filename=str(tmp_path / "o")),
               "train_ensemble_from_scratch", x, y, xt, yt, n_models=2)
    with pytest.raises(ValueError, match="element-wise"):
        _train("vmap", _unet(), dict(
            batch_size=4, training_cycles=2,
            optimizer=lambda p: torch.optim.LBFGS(p),
            filename=str(tmp_path / "o")), "train_ensemble_from_scratch",
            x, y, xt, yt, n_models=2)


# --------------------------------------------- vmap against JAX's vmap
def test_vmap_from_baseline_matches_jax_vmap(tmp_path):
    """The ensemble fixture (the JAX package's "vmap" layout, from one
    baseline, float32): the port's "vmap" layout as the loop is held in
    ``test_torch_ensemble.py``."""
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.ENSEMBLE_FIXTURE))
    E = script.ENSEMBLE
    bp = script.unflatten(stored, "base")
    et = EnsembleTrainer("Unet", 1, nb_filters=E["nb_filters"],
                         layers=E["layers"], device="cpu")
    et.compile_ensemble_trainer(batch_size=E["batch"], member_layout="vmap",
                                filename=str(tmp_path / "ens"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, ens = et.train_ensemble_from_baseline(
            stored["x_train"], stored["y_train"], stored["x_test"],
            stored["y_test"], basemodel=unet_from_jax(
                bp, chip_smoke.identity_stats(bp)),
            n_models=E["n_models"], training_cycles_ensemble=E["cycles"])
    np.testing.assert_array_equal(et.member_schedules, stored["schedules"])
    np.testing.assert_allclose(et.loss_acc["train_loss"],
                               stored["train_loss"], rtol=RTOL_LOSS)
    want = ensemble_from_jax(script.unflatten(stored, "member"),
                             et.meta_state_dict)
    for i in want:
        errs, tols = {}, {}
        chip_smoke.state_errors(ens[i], want[i], chip_smoke.TOL_ENS_ADAM,
                                errs, tols)
        assert not chip_smoke.failures(errs, tols), i


def test_vmap_imspec_from_baseline_matches_jax_vmap(tmp_path):
    """The ImSpec task from a SignalED baseline: the port's "vmap" against
    the JAX package's "vmap" on the same bridged weights (the loop's
    counterpart is ``test_torch_ensemble.py``'s
    ``test_imspec_task_from_baseline_matches_jax``)."""
    rng = np.random.RandomState(0)
    X = rng.rand(12, 16, 16).astype(np.float32)
    y = rng.rand(12, 16).astype(np.float32)
    signal = dict(nblayers_encoder=2, nblayers_decoder=2,
                  nbfilters_encoder=4, nbfilters_decoder=4)
    dims = dict(in_dim=(16, 16), out_dim=(16,), latent_dim=2)
    jet = JaxEnsembleTrainer("imspec", **dims, **signal)
    v = jax.device_get(jax.jit(lambda k, x0: dict(jet.net.init(
        {"params": k}, x0, False)))(jax.random.key(4), jnp.asarray(X[:1])))
    fit = dict(batch_size=4, loss="mse", member_layout="vmap")
    jet.compile_ensemble_trainer(mesh=False, filename=str(tmp_path / "j"),
                                 **fit)
    with jax.default_matmul_precision("highest"), \
            contextlib.redirect_stdout(io.StringIO()):
        jet.train_ensemble_from_baseline(
            X[:8], y[:8], X[8:], y[8:], basemodel=v["params"], n_models=2,
            training_cycles_ensemble=3)
    et = EnsembleTrainer("imspec", device="cpu", **dims, **signal)
    et.compile_ensemble_trainer(filename=str(tmp_path / "p"), **fit)
    base = signal_ed_from_jax(v["params"], v["batch_stats"],
                              et.meta_state_dict)
    with contextlib.redirect_stdout(io.StringIO()):
        _, ens = et.train_ensemble_from_baseline(
            X[:8], y[:8], X[8:], y[8:], basemodel=base, n_models=2,
            training_cycles_ensemble=3)
    np.testing.assert_allclose(et.loss_acc["train_loss"],
                               jet.loss_acc["train_loss"], rtol=RTOL_LOSS)
    want = ensemble_from_jax(jax.tree.map(np.asarray, jax.device_get(
        jet.ensemble_state_dict)), et.meta_state_dict)
    for i in want:
        errs, tols = {}, {}
        chip_smoke.state_errors(ens[i], want[i], chip_smoke.TOL_ENS_ADAM,
                                errs, tols)
        assert not chip_smoke.failures(errs, tols), i
