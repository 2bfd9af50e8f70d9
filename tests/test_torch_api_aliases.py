"""What the names that the API census asks for do, on the CPU, against the
JAX package's where both compute something: the trainers' ``fit``,
``data_augmentation``, ``get_loss_fn``, ``select_lr`` and
``print_statistics(**kwargs)``; ``BasePredictor.predict`` /
``batch_predict`` / ``preprocess`` on the same Unet weights (1e-5 of
scale, the plain forward's float32 tolerance); ``Locator.rem_edge_coord``
and ``data_split(format_out=)`` exactly; ``ensemble_forward_``; the VAE
trainers' ``set_encoder``, ``set_decoder``, ``load_weights_from_arrays``,
``compile_trainer(elbo_fn=)`` and ``set_data(memory_alloc=)``;
``load_*_model(meta_dict=)``; ``Precision``'s float32 ``param_dtype`` /
``output_dtype``; ``enable_fast_matmul``; the ``core`` re-exports; and
``peak_refinement`` of a frame with no atoms.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atomai_tpu_torch as aoi
from atomai_tpu import models as jmodels
from atomai_tpu import nets as jnets
from atomai_tpu import predictors as jpredictors
from atomai_tpu.utils import preproc as jpreproc
from atomai_tpu_torch import core, models, nets, predictors
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.models.conversion import unet_from_jax
from atomai_tpu_torch.utils import preproc

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = dict(nb_filters=4, layers=(1, 1, 1, 1), device="cpu")


def _seg_data(n=8, size=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size).astype(np.float32),
            (rng.rand(n, size, size) > 0.5).astype(np.float32))


def test_trainer_aliases(tmp_path, capsys):
    X, y = _seg_data()
    m = aoi.trainers.SegTrainer("Unet", 1, **SMALL)
    m.compile_trainer((X, y, X[:4], y[:4]), training_cycles=2,
                      batch_size=4, filename=str(tmp_path / "m"))
    seen = []

    def augment(g, Xb, yb):
        seen.append(Xb.shape)
        return Xb, yb
    m.data_augmentation(augment)
    assert m.select_lr(0) is None
    assert m.fit() is m.net and len(seen) == 2
    assert len(m.loss_acc["train_loss"]) == 2
    m.print_statistics(1, extra="ignored")
    assert "Epoch 2/2" in capsys.readouterr().out
    logits = np.random.RandomState(1).randn(2, 8, 8, 1).astype(np.float32)
    target = (logits > 0).astype(np.float32)[..., 0]
    for loss in ("ce", "dice", "focal", "mse"):
        got = m.get_loss_fn(loss, 1)(torch.from_numpy(logits),
                                     torch.from_numpy(target))
        want = jmodels.Segmentor("Unet", 1).get_loss_fn(loss, 1)(
            jnp.asarray(logits), jnp.asarray(target))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=loss)


def _unet_pair():
    kw = dict(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1))
    jnet = jnets.Unet(**kw)
    v = jnet.init({"params": jax.random.key(0), "dropout": jax.random.key(0)},
                  jnp.zeros((1, 16, 16, 1)), False)
    tnet = nets.Unet(**kw)
    tnet.load_state_dict(unet_from_jax(v["params"], v["batch_stats"]))
    return jnet, v, tnet.eval()


@pytest.mark.parametrize("num_batches", [1, 3])
def test_base_predictor_predict_matches_jax(num_batches):
    jnet, v, tnet = _unet_pair()
    x = np.random.RandomState(2).rand(5, 16, 16, 1).astype(np.float32)
    want = jpredictors.BasePredictor(jnet, v["params"], v["batch_stats"]
                                     ).predict(x, num_batches=num_batches)
    p = predictors.BasePredictor(tnet)
    xt = x.transpose(0, 3, 1, 2)
    assert p.preprocess(xt).dtype == torch.float32
    got = p.predict(xt, num_batches=num_batches)
    assert isinstance(got, np.ndarray) and got.shape == xt.shape
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want,
                               atol=1e-5 * np.abs(want).max())
    flat = p.batch_predict(p.preprocess(xt), (5, 256), num_batches)
    np.testing.assert_array_equal(flat, got.reshape(5, 256))
    assert p.predict(xt, out_shape=(256,)).shape == (5, 256)


def test_rem_edge_coord_matches_jax():
    rng = np.random.RandomState(3)
    coords = np.concatenate([rng.rand(200, 2) * 64, np.zeros((200, 1))], 1)
    for dist_edge in (0, 5, 12):
        want = jpredictors.Locator(dist_edge=dist_edge).rem_edge_coord(
            coords, 64, 48)
        got = predictors.Locator(dist_edge=dist_edge,
                                 device="cpu").rem_edge_coord(coords, 64, 48)
        np.testing.assert_array_equal(got, want)
    assert predictors.Locator(device="cpu").rem_edge_coord(
        np.zeros((0, 3)), 8, 8).shape == (0, 3)


def test_ensemble_forward_mean_and_variance():
    _, _, tnet = _unet_pair()
    members = {}
    for i in range(3):
        torch.manual_seed(i)
        members[i] = {k: v + 0.05 * torch.randn_like(v)
                      if v.is_floating_point() else v
                      for k, v in tnet.state_dict().items()}
    p = predictors.EnsemblePredictor(tnet, members, nb_classes=1,
                                     verbose=0)
    x = p.preprocess(np.random.RandomState(4).rand(4, 16, 16))
    preds = p.ensemble_forward(x)
    mean, var = p.ensemble_forward_(x)
    assert preds.shape == (3, 4, 16, 16, 1)
    np.testing.assert_array_equal(mean, preds.mean(0))
    np.testing.assert_array_equal(var, preds.var(0))
    m2, v2 = p.predict(x.numpy()[..., 0], num_batches=1)
    np.testing.assert_allclose(m2, mean, atol=1e-6)
    np.testing.assert_allclose(v2, var, atol=1e-6)


@pytest.mark.parametrize("format_out", ["numpy", "float", "torch_float",
                                        "torch_float_long"])
def test_data_split_format_out_matches_jax(format_out):
    rng = np.random.RandomState(5)
    X, y = rng.rand(11, 4, 4), rng.randint(0, 3, (11, 4, 4))
    got = preproc.data_split(X, y, 0.3, 2, format_out=format_out)
    want = jpreproc.data_split(X, y, 0.3, 2, format_out=format_out)
    for g, w in zip(got, want):
        if format_out.startswith("torch"):
            assert isinstance(g, torch.Tensor)
            g = g.numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for mod in (preproc, jpreproc):
        with pytest.raises(NotImplementedError, match="output format"):
            mod.data_split(X, y, format_out="pandas")


def test_vae_trainer_aliases(tmp_path):
    X = np.random.RandomState(0).rand(16, 8, 8).astype(np.float32)
    kw = dict(numhidden_encoder=8, numhidden_decoder=8, device="cpu")
    ref = models.load_model(os.path.join(FIXTURES, "torch_port_rvae.aoi"),
                            device="cpu")
    m = models.rVAE(ref.in_dim, **{**kw, **{
        k: ref.metadict[k] for k in ("numhidden_encoder",
                                     "numhidden_decoder", "latent_dim")}})
    arrays = core.load_checkpoint(os.path.join(FIXTURES,
                                               "torch_port_rvae.aoi"))[1]
    m.load_weights_from_arrays(arrays)
    for a, b in ((m.encoder_net, ref.encoder_net),
                 (m.decoder_net, ref.decoder_net)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    v = models.VAE((8, 8), **kw)
    enc, dec = nets.init_VAE_nets((8, 8), 2, numhidden_encoder=4,
                                  numhidden_decoder=4)[:2]
    v.set_encoder(enc)
    v.set_decoder(dec)
    assert v.encoder_net is enc and v.decoder_net is dec
    calls = []

    def elbo_fn(x, x_reconstr, *args, **kwargs):
        calls.append(x.shape)
        return -((x - x_reconstr) ** 2).mean()
    v.compile_trainer((X, None), elbo_fn=elbo_fn, batch_size=8)
    v.set_data(X, memory_alloc=1)
    v.train_epoch()
    assert calls == [(8, 8, 8), (8, 8, 8)]


@pytest.mark.parametrize("loader", ["load_seg_model", "load_vae_model"])
def test_typed_loaders_take_meta_dict(loader):
    path = os.path.join(FIXTURES, "torch_port_unet.aoi"
                        if loader == "load_seg_model"
                        else "torch_port_rvae.aoi")
    m = getattr(models, loader)(meta_dict=path, device="cpu")
    m2 = getattr(models, loader)(meta_dict=core.load_checkpoint(path),
                                 device="cpu")
    assert type(m) is type(m2)
    with pytest.raises(ValueError, match="not a"):
        models.load_imspec_model(meta_dict=path, device="cpu")


def test_precision_fields_and_fast_matmul(monkeypatch):
    for p in (core.Precision.full(), core.Precision.mixed()):
        assert p.param_dtype == p.output_dtype == torch.float32
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        monkeypatch.setenv("ATOMAI_TPU_PRECISION", "float32")
        aoi.enable_fast_matmul()
        assert torch.get_float32_matmul_precision() == "highest"
        monkeypatch.delenv("ATOMAI_TPU_PRECISION")
        aoi.enable_fast_matmul()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_core_reexports(tmp_path):
    from atomai_tpu_torch.core import export
    assert core.export_model is export.export_model is aoi.export_model
    assert core.load_exported is export.load_exported
    assert core.ExportedModel is export.ExportedModel
    assert core.trace is profiling.trace and core.annotate is \
        profiling.annotate
    assert core.device_memory_stats is profiling.device_memory_stats
    assert models.BaseVAE is models.dgm.BaseVAE
    tree = {"a": [torch.ones(2)], "b": (torch.zeros(1), 3)}
    assert profiling.block_until_ready(tree) is tree
    out = io.StringIO()
    with redirect_stdout(out):
        with core.trace(str(tmp_path), create_perfetto_link=True):
            with core.annotate("step"):
                torch.ones(3).sum()
    assert os.path.exists(tmp_path / "trace.json")
    assert "trace.json" in out.getvalue()


def test_net_signatures():
    block = nets.ResBlock(2, 1, 4, kernel_size=5, stride=2, padding=0)
    assert block(torch.zeros(1, 1, 6, 6)).shape == (1, 4, 6, 6)
    ed = nets.SignalED((8, 8), (16,), 2, 1, 4, 1, 4)
    x = torch.randn(2, 8, 8)
    torch.testing.assert_close(ed.decode(latent=ed.encode(features=x)),
                               ed(x))


def test_peak_refinement_of_no_atoms_matches_jax():
    """A frame where nothing was found: the JAX package returns an empty
    (0, 3) table; the port's batched fit raised on the empty batch."""
    from atomai_tpu.utils import peak_refinement as jax_refine
    img = np.random.RandomState(6).rand(32, 32).astype(np.float32)
    want = jax_refine(img, np.zeros((0, 3)), d=4)
    got = aoi.utils.peak_refinement(img, np.zeros((0, 3)), d=4,
                                    device="cpu")
    assert got.shape == want.shape == (0, 3) and got.dtype == want.dtype
