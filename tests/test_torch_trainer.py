"""The port's ``Segmentor.fit`` against the JAX package's, from the same
weights (carried by ``unet_from_jax``), on the same data, split and batch
schedule; and the trainer's contracts (`tests/trainers/test_trainer.py`).

Stated tolerances, all float32 on the CPU:
- per-cycle losses: 1e-5 relative (measured <= 1e-6; the two packages sum
  convolutions and BatchNorm statistics in different orders);
- trained parameters: 1e-3 of each tensor's largest |value|, or a
  hundredth of one Adam step (1e-5 at lr 1e-3) for a tensor that Adam
  moved away from 0 in these few steps (the BatchNorm biases, |w| ~ 3e-3).
  Adam moves a weight by about lr * g / |g| a step, so a near-zero
  gradient that rounds differently in the two packages is amplified to a
  fraction of a step. Measured: at most 2.8e-5 on conv kernels of scale
  0.06-0.3 (4.5e-4 of scale), 4e-6 on the BatchNorm biases;
- BatchNorm running variance: flax updates it with the biased batch
  variance, torch with the unbiased one (n / (n - 1), n = batch x height
  x width of the layer), so it may differ by 1 / (n_min - 1) relative,
  with n_min the smallest n of the net (4 x 4 x 4 = 64 here); running
  means to 1e-4;
- IoU accuracies: 2e-3 absolute, one flipped pixel of the 4,096 of a batch
  moving the score by at most ~5e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models import Segmentor as JaxSegmentor
from atomai_tpu_torch.models import Segmentor, load_model, unet_from_jax

torch.set_num_threads(1)

RTOL_LOSS = 1e-5
W_SCALED = 1e-3
W_ABS = 1e-5
RTOL_RUNNING_VAR = 1.0 / (64 - 1)
ATOL_RUNNING_MEAN = 1e-4
ATOL_IOU = 2e-3
SMALL = dict(nb_filters=4, layers=(1, 1, 1, 1), device="cpu")


def _data(seed=1, n=8, size=32, nb_classes=1):
    """Random images; random binary masks, or for several classes the
    image's intensity band (learnable, so that the gradients are not pure
    noise that Adam's normalisation would amplify)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, size, size).astype(np.float32)
    if nb_classes == 1:
        y = (rng.rand(n, size, size) > 0.5).astype(np.float32)
    else:
        y = np.digitize(X, np.linspace(0, 1, nb_classes + 1)[1:-1])
    return X, y, X.copy(), y.copy()


def _jax_variables(jm, X):
    v = jax.device_get(jm.net.init(
        {"params": jax.random.key(3), "dropout": jax.random.key(3)},
        jnp.asarray(X[:1, ..., None]), False))
    params = jax.tree.map(np.asarray, dict(v["params"]))
    stats = v.get("batch_stats")
    return params, (jax.tree.map(np.asarray, dict(stats)) if stats
                    else None)


def _pair(tmp_path, nb_classes=1, batch_norm=True, **fit_kw):
    """A JAX and a port Segmentor trained from the same weights."""
    X, y, Xt, yt = _data(nb_classes=nb_classes)
    jm = JaxSegmentor("Unet", nb_classes, seed=7, batch_norm=batch_norm,
                      **SMALL)
    params, stats = _jax_variables(jm, X)
    jm.params, jm.batch_stats = params, stats
    fit = dict(training_cycles=5, batch_size=4, print_loss=5, **fit_kw)
    jm.fit(X, y, Xt, yt, filename=str(tmp_path / "jax"), mesh=False, **fit)
    pm = Segmentor("Unet", nb_classes, seed=7, batch_norm=batch_norm,
                   **SMALL)
    pm.load_jax_variables(params, stats)
    pm.fit(X, y, Xt, yt, filename=str(tmp_path / "port"), **fit)
    return jm, pm


def _assert_same_trajectory(jm, pm):
    for k in ("train_loss", "test_loss"):
        assert len(pm.loss_acc[k]) == len(jm.loss_acc[k]) > 0
        np.testing.assert_allclose(pm.loss_acc[k], jm.loss_acc[k],
                                   rtol=RTOL_LOSS, err_msg=k)
    for k in ("train_accuracy", "test_accuracy"):
        assert len(pm.loss_acc[k]) == len(jm.loss_acc[k])
        np.testing.assert_allclose(pm.loss_acc[k], jm.loss_acc[k],
                                   atol=ATOL_IOU, err_msg=k)
    want = unet_from_jax(jax.tree.map(np.asarray, jm.params),
                         jax.tree.map(np.asarray, jm.batch_stats)
                         if jm.batch_stats else None)
    got = pm.net.state_dict()
    for k, w in want.items():
        g = got[k].float()
        if k.endswith("running_var"):
            np.testing.assert_allclose(g, w, rtol=RTOL_RUNNING_VAR,
                                       err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, atol=ATOL_RUNNING_MEAN,
                                       err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            err = float((g - w).abs().max())
            assert err <= max(W_SCALED * float(w.abs().max()), W_ABS), \
                (k, err)


@pytest.mark.parametrize("case,kw", [
    ("one_batch", {}),
    ("full_epoch", {"full_epoch": True}),
    ("swa_lr_schedule_iou", {"swa": True, "compute_accuracy": True,
                             "lr_scheduler": [1e-3, 5e-4, 2e-4]}),
    ("full_epoch_swa_lr_schedule", {"full_epoch": True, "swa": True,
                                    "lr_scheduler": [1e-3, 2e-4]}),
    ("perturb_without_noise", {"batch_norm": False, "perturb_weights":
                               {"a": 0.0, "gamma": 1.5, "e_p": 2}}),
    ("multiclass_ce_iou", {"nb_classes": 3, "compute_accuracy": True}),
    ("adamw", {"optimizer": "adamw"}),
    ("sgd_full_epoch", {"optimizer": "sgd", "full_epoch": True}),
])
def test_fit_trajectory_matches_jax(tmp_path, case, kw):
    jm, pm = _pair(tmp_path, **kw)
    _assert_same_trajectory(jm, pm)


def test_resume_training_matches_jax(tmp_path):
    """save_model(include_optimizer=True) then resume_training: the same
    continued trajectory (new batch schedule, restored Adam moments and
    step counts) in both packages."""
    jm, pm = _pair(tmp_path)
    jpath = jm.save_model(str(tmp_path / "jckpt"), include_optimizer=True)
    ppath = pm.save_model(str(tmp_path / "pckpt"), include_optimizer=True)
    jm.resume_training(jpath, additional_cycles=4)
    pm.resume_training(ppath, additional_cycles=4)
    assert len(pm.loss_acc["train_loss"]) == 9
    _assert_same_trajectory(jm, pm)
    fresh = Segmentor("Unet", 1, seed=7, **SMALL)
    with pytest.raises(RuntimeError, match="Compile"):
        fresh.resume_training(ppath)
    with pytest.raises(ValueError, match="optimizer state"):
        pm.resume_training(pm.save_model(str(tmp_path / "noopt")))


def test_batch_schedule_matches_jax():
    from atomai_tpu.trainers.trainer import _shuffled_batch_schedule as js
    from atomai_tpu_torch.trainers.trainer import \
        _shuffled_batch_schedule as ts
    for n_batches, cycles, seed in [(1, 5, 1), (3, 10, 7), (7, 300, 2),
                                    (5, 3, 0)]:
        np.testing.assert_array_equal(ts(n_batches, cycles, seed),
                                      js(n_batches, cycles, seed))


def test_data_split_and_staging_match_jax():
    """The same split and stacked batches as the JAX package's staging,
    for a data set that needs a split (config A's path)."""
    from atomai_tpu.trainers import SegTrainer as JaxSegTrainer
    X, y, _, _ = _data(n=13, size=16)
    jt = JaxSegTrainer("Unet", 1, **SMALL)
    jt.compile_trainer((X, y), training_cycles=2, batch_size=4,
                       mesh=False, test_size=0.3, seed=5)
    pm = Segmentor("Unet", 1, **SMALL)
    pm.compile_trainer((X, y), training_cycles=2, batch_size=4,
                       test_size=0.3, seed=5)
    for name in ("Xb_train", "yb_train", "Xb_test", "yb_test"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(pm.batch_idx_train, jt.batch_idx_train)


def _fit(m, **kw):
    """Six cycles of batch 4 on ``_data()``; ``kw`` overrides, and must
    name the ``filename`` the final save goes to."""
    X, y, Xt, yt = _data(nb_classes=m.nb_classes)
    m.fit(X, y, Xt, yt, **{"training_cycles": 6, "batch_size": 4,
                            "print_loss": 6, **kw})
    return m


def test_determinism_same_seed(tmp_path):
    """Same seed -> identical losses and weights, dropout included (its
    masks come from the run's generator)."""
    runs = [_fit(Segmentor("Unet", 1, seed=7, dropout=True, **SMALL),
                 filename=str(tmp_path / "det")) for _ in range(2)]
    assert runs[0].loss_acc == runs[1].loss_acc
    for a, b in zip(runs[0].net.state_dict().values(),
                    runs[1].net.state_dict().values()):
        assert torch.equal(a, b)


def test_different_seed_differs(tmp_path):
    a, b = (_fit(Segmentor("Unet", 1, seed=s, **SMALL),
                 filename=str(tmp_path / "seed")) for s in (1, 2))
    assert not torch.equal(a.net.c1.block[0].weight, b.net.c1.block[0].weight)


def test_loss_decreases(tmp_path):
    X, _, _, _ = _data(n=16)
    y = (X > 0.5).astype(np.float32)
    m = Segmentor("Unet", 1, **SMALL)
    m.fit(X, y, training_cycles=60, batch_size=8, print_loss=30,
          filename=str(tmp_path / "dec"))
    assert m.loss_acc["train_loss"][-1] < m.loss_acc["train_loss"][0]


def test_swa_changes_weights(tmp_path):
    a, b = (_fit(Segmentor("Unet", 1, seed=3, **SMALL), swa=swa,
                 filename=str(tmp_path / "swa")) for swa in (False, True))
    assert not torch.equal(a.net.c1.block[0].weight, b.net.c1.block[0].weight)
    mean, var = b.running_weights_stats
    assert set(mean) == set(dict(b.net.named_parameters()))
    assert all(bool((v >= 0).all()) for v in var.values())


def test_perturb_weights_requires_no_batch_norm(tmp_path):
    with pytest.raises(AssertionError, match="batch normalization"):
        _fit(Segmentor("Unet", 1, **SMALL), perturb_weights=True,
             filename=str(tmp_path / "pw"))


def test_perturbation_noise_sigma():
    """w += N(0, a / (1 + e)^gamma) every e_p cycles, nothing between."""
    m = Segmentor("Unet", 1, batch_norm=False, nb_filters=16,
                  layers=(1, 1, 1, 1), device="cpu")
    m.perturb_weights = {"a": 0.01, "gamma": 1.5, "e_p": 3}
    g = torch.Generator().manual_seed(0)
    before = torch.cat([p.detach().flatten().clone()
                        for p in m.net.parameters()])
    m._perturb(1, g)        # (e + 1) % 3 != 0: no change
    same = torch.cat([p.detach().flatten() for p in m.net.parameters()])
    assert torch.equal(before, same)
    m._perturb(5, g)
    noise = torch.cat([p.detach().flatten() for p in m.net.parameters()]) \
        - before
    sd = np.sqrt(0.01 / 6 ** 1.5)
    n = noise.numel()
    assert n > 50_000
    # the sample sd of n normal draws is within 4 / sqrt(2n) of sigma
    assert abs(float(noise.std()) / sd - 1) < 4 / np.sqrt(2 * n)
    assert abs(float(noise.mean())) < 4 * sd / np.sqrt(n)


def test_nb_classes_mismatch_raises(tmp_path):
    """Binary masks for a 3-class net, 3-class masks for a 1-class net,
    with and without a given test set."""
    for nb_net, nb_data in ((3, 1), (1, 3)):
        X, y, Xt, yt = _data(nb_classes=nb_data)
        for test in ((Xt, yt), (None, None)):
            m = Segmentor("Unet", nb_net, **SMALL)
            with pytest.raises(AssertionError, match="Number of classes"):
                m.fit(X, y, *test, training_cycles=2, batch_size=4,
                      filename=str(tmp_path / "mm"))


def test_unported_options_raise(tmp_path):
    """A ``mesh`` that is not a ``DeviceMesh`` raises (meshes:
    ``test_torch_mesh.py``, ``test_torch_multidevice.py``); ``remat=True``
    trains, with the Unet's blocks checkpointed (its exactness:
    ``test_torch_remat.py``)."""
    m = Segmentor("Unet", 1, **SMALL)
    X, y, Xt, yt = _data()
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.fit(X, y, Xt, yt, training_cycles=1, batch_size=4,
              filename=str(tmp_path / "x"), mesh=object())
    r = Segmentor("Unet", 1, **SMALL)
    r.fit(X, y, Xt, yt, training_cycles=2, batch_size=4,
          filename=str(tmp_path / "r"), remat=True)
    assert r.remat and r.net.c1.remat and r.net.upsample_block1.remat
    assert len(r.loss_acc["train_loss"]) == 2 and \
        np.isfinite(r.loss_acc["train_loss"]).all()
    with pytest.raises(ValueError, match="Unknown optimizer"):
        m.fit(X, y, Xt, yt, training_cycles=1, batch_size=4,
              optimizer="rmsprop", filename=str(tmp_path / "x"))


def test_custom_optimizer_callable(tmp_path):
    m = _fit(Segmentor("Unet", 1, **SMALL),
             optimizer=lambda p: torch.optim.SGD(p, lr=0.0),
             filename=str(tmp_path / "sgd0"))
    before = Segmentor("Unet", 1, **SMALL)   # same seed: same weights
    assert torch.equal(m.net.c1.block[0].weight, before.net.c1.block[0].weight)


def test_test_loss_measured_on_clean_data(tmp_path):
    """With a destructive augmentation, the recorded test loss equals an
    evaluation of the clean test batch with the final weights."""
    m = Segmentor("Unet", 1, **SMALL)
    X, y, Xt, yt = _data(seed=2)
    m.fit(X, y, Xt, yt, training_cycles=3, batch_size=8, print_loss=3,
          filename=str(tmp_path / "clean"),
          custom_transform=lambda imgs, gts: (torch.zeros_like(imgs), gts))
    assert m.augment_fn is not None
    (clean,) = m.test_step(m.Xb_test[0], m.yb_test[0])
    np.testing.assert_allclose(m.loss_acc["test_loss"][-1], clean,
                               rtol=1e-6)


def test_train_step_and_test_step():
    m = Segmentor("Unet", 1, **SMALL)
    X, y, _, _ = _data(n=4)
    m.criterion = None
    (loss,) = m.train_step(X[..., None], y)    # Adam(1e-3) + MSE default
    assert np.isfinite(loss)
    from atomai_tpu_torch.losses_metrics import select_loss
    m.criterion = select_loss("ce", 1)
    m.compute_accuracy = True
    loss, acc = m.test_step(X[..., None], y)
    assert np.isfinite(loss) and 0 <= acc <= 1


def test_metrics_log_jsonl(tmp_path):
    path = tmp_path / "run.jsonl"
    m = _fit(Segmentor("Unet", 1, **SMALL), training_cycles=5,
             print_loss=2, compute_accuracy=True, metrics_log=str(path),
             filename=str(tmp_path / "mlog"))
    recs = [json.loads(line) for line in open(path)]
    assert [r["cycle"] for r in recs] == list(range(5))
    assert all({"wall_s", "train_loss", "test_loss", "train_accuracy",
                "test_accuracy"} <= set(r) for r in recs)
    np.testing.assert_allclose([r["train_loss"] for r in recs],
                               m.loss_acc["train_loss"], rtol=1e-6)


def test_save_load_predict_round_trip(tmp_path):
    m = _fit(Segmentor("Unet", 1, dropout=True, **SMALL),
             filename=str(tmp_path / "rt"))
    path = m.save_model(str(tmp_path / "saved"))
    assert path.endswith(".aoit")
    assert (tmp_path / "rt_metadict_final.aoit").exists()
    m2 = load_model(path, device="cpu")
    assert isinstance(m2, Segmentor)
    assert m2.meta_state_dict["nb_filters"] == 4
    imgs = _data(seed=9, n=3)[0]
    a = m.predict(imgs, compute_coords=False, verbose=False)
    b = m2.predict(imgs, compute_coords=False, verbose=False)
    np.testing.assert_array_equal(a, b)
    m3 = Segmentor("Unet", 1, seed=99, dropout=True, **SMALL)
    m3.load_weights(path)
    np.testing.assert_array_equal(
        m3.predict(imgs, compute_coords=False, verbose=False), a)


def test_load_model_vae_and_unported(tmp_path):
    from atomai_tpu_torch.models import rVAE
    v = rVAE((8, 8), latent_dim=2, numlayers_encoder=1, numhidden_encoder=8,
             numlayers_decoder=1, numhidden_decoder=8, device="cpu")
    X = np.random.RandomState(0).rand(32, 8, 8).astype(np.float32)
    v.fit(X, training_cycles=2, batch_size=16,
          filename=str(tmp_path / "rvae"), verbose=False)
    v2 = load_model(str(tmp_path / "rvae.aoit"), device="cpu")
    assert type(v2) is rVAE and v2.num_iter == v.num_iter == 4
    np.testing.assert_allclose(v2.encode(X[:4])[0], v.encode(X[:4])[0],
                               atol=1e-6)
    # the JAX package's own .aoi checkpoint of an rVAE loads too
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_port_rvae.aoi")
    r = load_model(fixture, device="cpu")
    assert type(r) is rVAE and r.num_iter == 8 and r.in_dim == (32, 32)
    # joint VAEs are ported: a jVAE's checkpoint loads as a jVAE
    from atomai_tpu_torch.core import save_checkpoint
    from atomai_tpu_torch.models import jVAE
    j = jVAE((8, 8), latent_dim=2, discrete_dim=[3], numlayers_encoder=1,
             numhidden_encoder=8, numlayers_decoder=1, numhidden_decoder=8,
             device="cpu")
    j.fit(X, training_cycles=1, batch_size=16,
          filename=str(tmp_path / "jvae"), verbose=False)
    j2 = load_model(str(tmp_path / "jvae.aoit"), device="cpu")
    assert type(j2) is jVAE and j2.discrete_dim == [3]
    for a, b in zip(j2.encode(X[:4]), j.encode(X[:4])):
        np.testing.assert_array_equal(a, b)
    unknown = save_checkpoint(str(tmp_path / "other"),
                              {"model_type": "other"}, {})
    with pytest.raises(ValueError, match="Unknown model type"):
        load_model(unknown, device="cpu")


def test_cuda_trainer_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Segmentor("Unet", 1, device="cuda")


def _default_device_segmentor(tmp_path):
    return Segmentor("Unet", 1, nb_filters=4, layers=(1, 1, 1, 1))


def _default_device_rvae(tmp_path):
    from atomai_tpu_torch.models import rVAE
    return rVAE((8, 8), latent_dim=2, numhidden_encoder=8,
                numhidden_decoder=8)


def _default_device_load_model(tmp_path):
    path = Segmentor("Unet", 1, **SMALL).save_model(str(tmp_path / "m"))
    return load_model(path)


def _default_device_locator(tmp_path):
    from atomai_tpu_torch.predictors import Locator
    return Locator(0.5).run(np.zeros((2, 16, 16, 1), np.float32))


def _default_device_peak_refinement(tmp_path):
    from atomai_tpu_torch.utils import peak_refinement
    return peak_refinement(np.zeros((16, 16), np.float32),
                           np.array([[8.0, 8.0, 0.0]]), d=3)


def _default_device_find_com(tmp_path):
    from atomai_tpu_torch.utils import find_com
    return find_com(np.ones((16, 16), np.float32))


def _default_device_blob_params(tmp_path):
    from atomai_tpu_torch.utils import get_blob_params
    return get_blob_params(np.ones((1, 16, 16), np.float32), 0.5, 5)


def _default_device_dklgpr(tmp_path):
    from atomai_tpu_torch.models import dklGPR
    return dklGPR(4, embedim=2)


def _default_device_gptrainer(tmp_path):
    from atomai_tpu_torch.trainers import GPTrainer
    return GPTrainer()


def _default_device_reconstructor(tmp_path):
    from atomai_tpu_torch.models import Reconstructor
    return Reconstructor()


def _default_device_zoo_segmentor(tmp_path):
    return Segmentor("SegResNet", 1, nb_filters=4, layers=(1, 1, 1))


def _default_device_regressor(tmp_path):
    from atomai_tpu_torch.models import Regressor
    return Regressor("vgg-slim", 1)


def _default_device_classifier(tmp_path):
    from atomai_tpu_torch.models import Classifier
    return Classifier("vgg-slim", 2)


def _default_device_denoiser(tmp_path):
    from atomai_tpu_torch.models import DenoisingAutoencoder
    return DenoisingAutoencoder()


def _default_device_zoo_ensemble(tmp_path):
    from atomai_tpu_torch.trainers import EnsembleTrainer
    return EnsembleTrainer("dilnet", 1, nb_filters=4)


def _default_device_load_reg_model(tmp_path):
    from atomai_tpu_torch.models import Regressor
    path = Regressor("vgg-slim", 1, device="cpu").save_model(
        str(tmp_path / "reg"))
    return load_model(path)


def _default_device_example(name):
    """The ``main`` of an ``examples_torch/`` script, run without
    ``--device``."""
    def make(tmp_path):
        import runpy
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples_torch", name + ".py")
        return runpy.run_path(path)["main"](["--smoke", "--out",
                                             str(tmp_path)])
    make.__name__ = f"_default_device_example_{name}"
    return make


@pytest.mark.parametrize("make", [_default_device_segmentor,
                                  _default_device_zoo_segmentor,
                                  _default_device_regressor,
                                  _default_device_classifier,
                                  _default_device_denoiser,
                                  _default_device_zoo_ensemble,
                                  _default_device_load_reg_model,
                                  _default_device_rvae,
                                  _default_device_load_model,
                                  _default_device_locator,
                                  _default_device_peak_refinement,
                                  _default_device_find_com,
                                  _default_device_blob_params,
                                  _default_device_dklgpr,
                                  _default_device_gptrainer,
                                  _default_device_reconstructor] + [
    _default_device_example(n) for n in (
        "segmentation_workflow", "rvae_workflow", "ensemble_uncertainty",
        "dkl_active_learning", "graph_analysis_notebook")])
def test_entry_points_default_to_the_card(make, tmp_path):
    """Without ``device``, an entry point runs on the card: with no card it
    raises instead of returning a model, or coordinates of numpy input,
    made on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(tmp_path)


def _record_tf32_in_backward(module, seen):
    """Appends cuDNN's TF32 switch to ``seen`` whenever a gradient flows
    back through ``module``'s first output."""
    def hook(mod, inputs, out):
        first = out[0] if isinstance(out, tuple) else out
        if first.requires_grad:
            first.register_hook(
                lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    return module.register_forward_hook(hook)


def test_backward_runs_under_the_policy_tf32_switches(monkeypatch, tmp_path):
    """The backward passes of both trainers read the precision policy's TF32
    switches, not torch's defaults (cuDNN's is TF32 on): a float32 policy
    trains in float32 on the card."""
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import rVAE
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    m = Segmentor("Unet", 1, **SMALL)
    m.precision = Precision.full()
    _record_tf32_in_backward(m.net, seen)
    _fit(m, training_cycles=2, filename=str(tmp_path / "tf32"))
    v = rVAE((8, 8), latent_dim=2, numlayers_encoder=1, numhidden_encoder=8,
             numlayers_decoder=1, numhidden_decoder=8, device="cpu")
    v.precision = Precision.full()
    _record_tf32_in_backward(v.encoder_net, seen)
    v.fit(np.random.RandomState(0).rand(32, 8, 8).astype(np.float32),
          training_cycles=1, batch_size=16, filename=str(tmp_path / "v"),
          verbose=False)
    assert seen == [False] * 4
    assert torch.backends.cudnn.allow_tf32 is True
