"""The port's ImSpec path against the JAX package's: the 1D ConvBlock, the
DilatedBlock, SignalED, ``check_signal_dims`` / ``format_spectra``,
``ImSpec.fit`` from the same weights (carried by ``signal_ed_from_jax``)
and batches, ``predict``, and the ``.aoit`` round trip.

Stated tolerances, float32 on the CPU:
- nets: 1e-5 absolute, forward in train and in eval mode (XLA:CPU ignores
  the JAX package's bf16 matmul setting);
- five ``fit`` cycles: train losses 1e-3 relative; weights within
  2 * lr * steps (Adam moves a weight by about lr a step, so a near-zero
  gradient that rounds differently in the two packages may move it the
  other way); the eval-mode test losses and ``predict`` after training
  within the BatchNorm bound below;
- ``predict`` of the same weights: 1e-5 absolute.

BatchNorm bound: flax updates the running variance with the biased batch
variance, torch with the unbiased one (n / (n - 1)); the decoder's 1D
BatchNorms see n = batch x length = 8 x 32, so after five updates with
momentum 0.1 the running variances differ by up to 0.41 / 255 relative
and the eval-mode outputs by about half that: 1e-3 relative on the test
losses, 1e-3 absolute on ``predict`` (measured 2.3e-4 and 2.5e-4).
"""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models import ImSpec as JaxImSpec
from atomai_tpu.nets import blocks as jblocks
from atomai_tpu.nets.ed import init_imspec_model as jax_init_imspec_model
from atomai_tpu.utils import preproc as jpreproc
import atomai_tpu_torch as aoi
from atomai_tpu_torch.models import ImSpec, load_model, signal_ed_from_jax
from atomai_tpu_torch.models.conversion import _conv_block
from atomai_tpu_torch.nets import (ConvBlock, DilatedBlock,
                                   init_imspec_model)

torch.set_num_threads(1)

TOL_NET = 1e-5
TOL_LOSS_REL = 1e-3
LR, CYCLES = 1e-3, 5
TOL_ADAM = 2 * LR * CYCLES
TOL_BN_LOSS_REL = 1e-3
TOL_BN_PREDICT = 1e-3
TOL_PREDICT = 1e-5
SMALL = dict(nblayers_encoder=2, nblayers_decoder=2, nbfilters_encoder=4,
             nbfilters_decoder=4)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _random_stats(stats, seed=1):
    """BatchNorm statistics away from identity, so that their mapping
    counts."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (0.5 + rng.rand(*a.shape)).astype(
        np.float32), stats)


def _jax_apply(net, variables, x, train):
    if train:
        y, _ = net.apply(variables, jnp.asarray(x), True,
                         mutable=["batch_stats"])
        return np.asarray(y)
    return np.asarray(net.apply(variables, jnp.asarray(x), False))


def _port_apply(net, x, train):
    net.train(train)
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


BLOCKS = {
    "conv1d": lambda: (
        jblocks.ConvBlock(1, 2, 5, batch_norm=True, lrelu_a=0.1),
        ConvBlock(1, 2, 3, 5, batch_norm=True, lrelu_a=0.1), (6, 3, 12)),
    "dilated1d": lambda: (
        jblocks.DilatedBlock(1, 5, [1, 2, 3], [1, 2, 3], lrelu_a=0.1,
                             batch_norm=True),
        DilatedBlock(1, 3, 5, [1, 2, 3], [1, 2, 3], lrelu_a=0.1,
                     batch_norm=True), (6, 3, 16)),
    "dilated2d": lambda: (
        jblocks.DilatedBlock(2, 4, [1, 2], [1, 2], batch_norm=True),
        DilatedBlock(2, 2, 4, [1, 2], [1, 2], batch_norm=True),
        (3, 2, 10, 10)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_jax(name, train):
    """The DilatedBlock sums every sub-layer's output (conv, activation,
    BatchNorm), as the JAX block does."""
    jnet, tnet, shape = BLOCKS[name]()
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    x_last = np.moveaxis(x, 1, -1)
    v = _np(jnet.init({"params": jax.random.key(0)}, jnp.asarray(x_last),
                      False))
    stats = _random_stats(v["batch_stats"])
    state = _conv_block(v["params"], stats, False, name, len(shape))
    if name.startswith("dilated"):
        state = {"atrous_module" + k[len("block"):]: t
                 for k, t in state.items()}
    tnet.load_state_dict(state, strict=True)
    want = _jax_apply(jnet, {"params": v["params"], "batch_stats": stats},
                      x_last, train)
    got = np.moveaxis(_port_apply(tnet, x, train), 1, -1)
    np.testing.assert_allclose(got, want, atol=TOL_NET, rtol=0)


NETS = {
    "im2spec_downsampling": ((8, 8), (16,), dict(encoder_downsampling=2)),
    "spec2im_upsampling": ((16,), (8, 8), dict(decoder_upsampling=True)),
    "spec2spec": ((16,), (12,), {}),
    "im2im_upsampling": ((8, 8), (8, 8), dict(decoder_upsampling=True)),
}


def _pair_nets(in_dim, out_dim, **kw):
    kw = dict(SMALL, nblayers_decoder=3, nbfilters_decoder=5, **kw)
    jnet, jmeta = jax_init_imspec_model(in_dim, out_dim, 3, **kw)
    tnet, tmeta = init_imspec_model(in_dim, out_dim, 3, **kw)
    return jnet, tnet, tmeta


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(NETS))
def test_signal_ed_matches_jax(name, train):
    in_dim, out_dim, kw = NETS[name]
    jnet, tnet, meta = _pair_nets(in_dim, out_dim, **kw)
    x = np.random.RandomState(0).rand(6, *in_dim).astype(np.float32)
    v = _np(jnet.init({"params": jax.random.key(1)}, jnp.asarray(x), False))
    stats = _random_stats(v["batch_stats"])
    tnet.load_state_dict(signal_ed_from_jax(v["params"], stats, meta),
                         strict=True)
    want = _jax_apply(jnet, {"params": v["params"], "batch_stats": stats},
                      x, train)
    got = _port_apply(tnet, x, train)
    assert got.shape == want.shape == (6, *out_dim)
    np.testing.assert_allclose(got, want, atol=TOL_NET, rtol=0)


def test_init_imspec_model_metadict_and_sizes_match_jax():
    kw = dict(SMALL, encoder_downsampling=2, decoder_upsampling=True)
    jnet, jmeta = jax_init_imspec_model((8, 8), (16,), 3, **kw)
    tnet, tmeta = init_imspec_model((8, 8), (16,), 3, **kw)
    assert tmeta == jmeta
    v = jnet.init({"params": jax.random.key(0)}, jnp.zeros((1, 8, 8)),
                  False)
    assert sum(a.size for a in jax.tree.leaves(v["params"])) == \
        sum(p.numel() for p in tnet.parameters())
    assert set(init_imspec_model((8, 8), (16,), 2)[1]) == set(
        jax_init_imspec_model((8, 8), (16,), 2)[1])


def test_signal_ed_from_jax_rejects_a_tree_that_does_not_fit():
    jnet, tnet, meta = _pair_nets((16,), (8, 8), decoder_upsampling=True)
    v = _np(jnet.init({"params": jax.random.key(1)}, jnp.zeros((1, 16)),
                      False))
    with pytest.raises(ValueError, match="decoder"):
        signal_ed_from_jax(v["params"], v["batch_stats"],
                           dict(meta, decoder_upsampling=False))


@pytest.mark.parametrize("shapes", [
    ((5, 1, 8, 8), (5, 16, 1), (3, 8, 8, 1), (3, 16)),
    ((5, 16), (5, 8, 8), (3, 1, 16), (3, 8, 8))])
def test_check_signal_dims_and_format_spectra_match_jax(shapes):
    rng = np.random.RandomState(0)
    arrays = [rng.rand(*s).astype(np.float32) for s in shapes]
    for got, want in zip(aoi.utils.check_signal_dims(*arrays),
                         jpreproc.check_signal_dims(*arrays)):
        np.testing.assert_array_equal(got, want)
    spectra = rng.rand(4, 1, 16) * 3
    for norm in (False, True):
        np.testing.assert_array_equal(
            aoi.utils.format_spectra(spectra, norm),
            jpreproc.format_spectra(spectra, norm))
    with pytest.raises(ValueError, match="same"):
        aoi.utils.check_signal_dims(arrays[0], arrays[1], arrays[0][..., :4],
                                    arrays[3])


def _data(n=24, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 16, 16).astype(np.float32),
            rng.rand(n, 32).astype(np.float32))


def _fit_pair(tmp, **fit_kw):
    """A JAX and a port ImSpec trained from the same variables."""
    X, y = _data()
    jm = JaxImSpec((16, 16), (32,), latent_dim=3, seed=3, **SMALL)
    v = _np(jm.net.init({"params": jax.random.key(5)}, jnp.asarray(X[:1]),
                        False))
    jm.params, jm.batch_stats = v["params"], v["batch_stats"]
    pm = ImSpec((16, 16), (32,), latent_dim=3, seed=3, device="cpu",
                **SMALL)
    pm.load_jax_variables(jm.params, jm.batch_stats)
    fit = dict(training_cycles=CYCLES, batch_size=8, print_loss=CYCLES,
               **fit_kw)
    jm.fit(X[:16], y[:16], X[16:], y[16:], filename=f"{tmp}/jax",
           mesh=False, **fit)
    pm.fit(X[:16], y[:16], X[16:], y[16:], filename=f"{tmp}/port", **fit)
    return jm, pm, X[16:]


# contrast=(20, 21) draws the level 20 for every image: a real op whose
# outcome does not depend on either package's random numbers
@pytest.mark.parametrize("fit_kw", [{}, {"contrast": (20, 21)}],
                         ids=["plain", "contrast"])
def test_fit_trajectory_and_predict_match_jax(tmp_path, fit_kw):
    jm, pm, Xt = _fit_pair(str(tmp_path), **fit_kw)
    assert (pm.augment_fn is None) == (not fit_kw)
    np.testing.assert_array_equal(pm.batch_idx_train, jm.batch_idx_train)
    np.testing.assert_allclose(pm.loss_acc["train_loss"],
                               jm.loss_acc["train_loss"], rtol=TOL_LOSS_REL)
    np.testing.assert_allclose(pm.loss_acc["test_loss"],
                               jm.loss_acc["test_loss"],
                               rtol=TOL_BN_LOSS_REL)
    want = signal_ed_from_jax(_np(jm.params), _np(jm.batch_stats),
                              pm.meta_state_dict)
    got = pm.net.state_dict()
    for k, w in want.items():
        if k.endswith(("running_var", "running_mean", "tracked")):
            continue
        err = float((got[k] - w).abs().max())
        assert err <= TOL_ADAM, (k, err)
    pred_j = jm.predict(Xt, verbose=False)
    pred_t = pm.predict(Xt, verbose=False)
    assert pred_t.shape == pred_j.shape == (len(Xt), 32)
    np.testing.assert_allclose(pred_t, pred_j, atol=TOL_BN_PREDICT, rtol=0)


@pytest.mark.parametrize("direction", ["im2spec", "spec2im"])
def test_predict_matches_jax_on_the_same_weights(direction):
    """ImSpecPredictor: normalisation, chunks (num_batches with a
    remainder) and output shape, at 1e-5."""
    in_dim, out_dim = ((16, 16), (32,)) if direction == "im2spec" \
        else ((32,), (16, 16))
    jm = JaxImSpec(in_dim, out_dim, latent_dim=3, **SMALL)
    x = np.random.RandomState(1).rand(7, *in_dim).astype(np.float32) * 5
    v = _np(jm.net.init({"params": jax.random.key(2)}, jnp.asarray(x[:1]),
                        False))
    jm.params, jm.batch_stats = v["params"], _random_stats(v["batch_stats"])
    pm = ImSpec(in_dim, out_dim, latent_dim=3, device="cpu", **SMALL)
    pm.load_jax_variables(jm.params, jm.batch_stats)
    for kw in ({}, {"num_batches": 3}, {"norm": False}):
        want = jm.predict(x, verbose=False, **kw)
        got = pm.predict(x, verbose=False, **kw)
        assert got.shape == want.shape == (7, *out_dim)
        np.testing.assert_allclose(got, want, atol=TOL_PREDICT, rtol=0)


def test_save_model_load_model_round_trip(tmp_path):
    m = ImSpec((16, 16), (32,), latent_dim=3, device="cpu",
               encoder_downsampling=2, **SMALL)
    X, y = _data(12)
    m.fit(X, y, training_cycles=2, batch_size=4, print_loss=2,
          filename=str(tmp_path / "fit"))
    path = m.save_model(str(tmp_path / "saved"))
    m2 = load_model(path, device="cpu")
    assert type(m2) is ImSpec
    assert m2.meta_state_dict["encoder_downsampling"] == 2
    np.testing.assert_array_equal(m2.predict(X[:3], verbose=False),
                                  m.predict(X[:3], verbose=False))
    m3 = ImSpec((16, 16), (32,), latent_dim=3, seed=9, device="cpu",
                encoder_downsampling=2, **SMALL)
    m3.load_weights(path)
    np.testing.assert_array_equal(m3.predict(X[:3], verbose=False),
                                  m.predict(X[:3], verbose=False))


def test_augmentor_and_dims_checks():
    from atomai_tpu_torch.transforms import imspec_augmentor
    assert imspec_augmentor((16, 16), (32,)) is None
    assert imspec_augmentor((16, 16), (32,), rotation=True) is None
    with pytest.raises(NotImplementedError, match="img->spec"):
        imspec_augmentor((32,), (16, 16), gauss_noise=True)
    m = ImSpec((16, 16), (32,), device="cpu", **SMALL)
    X, y = _data(12)
    with pytest.raises(AssertionError, match="dimensions"):
        m.fit(X[:, :8], y, training_cycles=1, batch_size=4,
              filename=tempfile.mkdtemp() + "/x")
    with pytest.raises(NotImplementedError, match="Queue 1 #21"):
        m.fit(X, y, training_cycles=1, batch_size=4, mesh=object(),
              filename=tempfile.mkdtemp() + "/x")


def test_metadict_is_json():
    m = ImSpec((16, 16), (32,), device="cpu", **SMALL)
    assert json.loads(json.dumps(m.meta_state_dict))["model_type"] == \
        "imspec"


def test_chip_smoke_protocol_copy_equals_the_script():
    """chip_smoke.py keeps its own copy of the ImSpec quality protocol's
    data and score (`scripts/measure_imspec_parity.py`)."""
    import importlib.util
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    spec = importlib.util.spec_from_file_location(
        "_imspec_parity", os.path.join(root, "scripts",
                                       "measure_imspec_parity.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for got, want in zip(chip_smoke.make_paired_data(),
                         script.make_paired_data()):
        np.testing.assert_array_equal(got, want)
    assert (chip_smoke.PAIRED_N, chip_smoke.PAIRED_IN, chip_smoke.PAIRED_OUT,
            chip_smoke.PAIRED_TEST, chip_smoke.PAIRED_CYCLES,
            chip_smoke.PAIRED_BATCH, chip_smoke.PAIRED_SEEDS) == (
        script.N, script.IN_DIM, script.OUT_DIM, script.N_TEST,
        script.CYCLES, script.BATCH, script.SEEDS)
    rng = np.random.RandomState(3)
    pred, true = rng.rand(9, 32), rng.rand(9, 32)
    assert chip_smoke.imspec_score(pred, true) == script.score(pred, true)
