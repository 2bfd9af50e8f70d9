"""The port reads the JAX package's own checkpoints (``.aoi``): its msgpack
reader against flax's, every model type written by the JAX package and
loaded by ``atomai_tpu_torch.load_model`` (equal forwards), the VAE
counters, ensembles, ``load_weights`` and ``resume_training`` from the
JAX package's optax Adam state.

Tolerances: the reader is exact (bit for bit); forwards of the same
weights in float32 on the CPU within 1e-5 of the output's scale (sums of
a few hundred products; measured <= 1e-6); resumed losses within 1e-3
relative, the seg-train fixture's bound (measured <= 3e-5 on these small
nets). Variables are drawn with numpy from a seed
(``seeded_variables`` of ``scripts/make_torch_port_fixtures.py``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack as msgpack_lib
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

import atomai_tpu as J
from atomai_tpu.core.checkpoint import save_checkpoint as jax_save
from atomai_tpu_torch import load_ensemble, load_model
from atomai_tpu_torch.core import checkpoint, msgpack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_FWD = 1e-5
RTOL_LOSS = 1e-3
CPU = dict(device="cpu")


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_fx_aoi", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()


def _variables(net, x, seed=0):
    flat = FX.seeded_variables(FX.variable_shapes(net, x), seed)
    return FX.unflatten(flat, "params"), FX.unflatten(flat, "batch_stats")


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ----------------------------------------------------------- the reader
_DTYPES = [np.float32, np.float64, ml_dtypes.bfloat16, np.int32, np.uint8,
           np.bool_]


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    a = np.asarray(np.random.RandomState(seed).randn(*shape) * 50)
    return a.astype(dtype)


_leaves = st.one_of(_arrays(), st.integers(-2 ** 63, 2 ** 64 - 1),
                    st.floats(allow_nan=False), st.booleans(), st.none(),
                    st.text(max_size=40))
_trees = st.recursive(
    _leaves, lambda kids: st.dictionaries(st.text(min_size=1, max_size=8),
                                          kids, max_size=5), max_leaves=12)


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    else:
        assert type(got) is type(want) and got == want


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_msgpack_reader_matches_flax(tree):
    data = serialization.msgpack_serialize(
        tree if isinstance(tree, dict) else {"leaf": tree})
    _same(msgpack.restore(data), serialization.msgpack_restore(data))


def test_msgpack_reader_large_and_scalar_payloads():
    """bin32/ext32 (leaves over 64 KiB), str16/32, map16/32, array16/32,
    every int width, float32 and float64, 0-d arrays, numpy scalars and
    complex numbers."""
    rng = np.random.RandomState(0)
    tree = {"big": rng.randn(70000).astype(np.float32),      # ext32
            "bf16": rng.randn(40000).astype(ml_dtypes.bfloat16),
            "zero_d": np.array(3.5, np.float64), "empty": np.zeros((0, 3)),
            "scalar": np.float32(2.5), "i8": np.int8(-3),
            "complex": 1.5 - 2j, "many": {str(i): i for i in range(20)},
            "text": "x" * 70000, "mid": "y" * 300}
    data = serialization.msgpack_serialize(tree)
    _same(msgpack.restore(data), serialization.msgpack_restore(data))
    plain = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                      -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                      2 ** 64 - 1, -2 ** 63],
             "floats": [1.5, -0.1], "list16": list(range(20)),
             "list32": [1] * 70000, "map32": {str(i): 0 for i in range(70000)},
             "bin8": b"ab", "bin16": b"c" * 300, "bin32": b"d" * 70000,
             "nil": None, "bools": [True, False]}
    for single in (False, True):
        data = msgpack_lib.packb(plain, use_bin_type=True,
                                 use_single_float=single)
        assert msgpack.unpackb(data) == msgpack_lib.unpackb(data, raw=False)
    ext = msgpack_lib.packb([msgpack_lib.ExtType(5, b"xyz" * k)
                             for k in (0, 1, 2, 100, 30000)])
    assert [tuple(e) for e in msgpack.unpackb(ext)] == [
        (5, b"xyz" * k) for k in (0, 1, 2, 100, 30000)]
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(data[:-3])


def test_msgpack_reader_joins_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    tree = {"a": {"w": np.arange(3000, dtype=np.float32).reshape(30, 100)},
            "b": np.arange(10, dtype=np.int32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(msgpack.restore(data), serialization.msgpack_restore(data))


def test_checkpoint_paths(tmp_path):
    """A bare name is <name>.aoit if that exists, else <name>.aoi."""
    jax_save(str(tmp_path / "m"), {"model_type": "x"},
             {"params": {"Dense_0": {"kernel": np.ones((2, 3))}}})
    meta, arrays = checkpoint.load_checkpoint(str(tmp_path / "m"))
    assert meta == {"model_type": "x"} and checkpoint.is_jax_tree(arrays)
    np.testing.assert_array_equal(arrays["params"]["Dense_0"]["kernel"],
                                  np.ones((2, 3)))
    checkpoint.save_checkpoint(str(tmp_path / "m"), {"model_type": "y"},
                               {"params": {"w.weight": torch.zeros(2)}})
    meta, arrays = checkpoint.load_checkpoint(str(tmp_path / "m"))
    assert meta == {"model_type": "y"}
    assert not checkpoint.is_jax_tree(arrays)
    assert checkpoint.resolve_path(str(tmp_path / "none")).endswith(
        "none.aoit")


# -------------------------------------------------- models of each type
def _jax_forward(net, params, stats, x):
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda xx: net.apply(v, xx, False))(x))


SUPERVISED = {
    "unet": (lambda: J.models.Segmentor("Unet", 1, nb_filters=4,
                                        layers=[1, 1, 1, 1],
                                        with_dilation=True),
             (2, 32, 32, 1)),
    "segresnet": (lambda: J.models.Segmentor("SegResNet", 2, nb_filters=4,
                                             layers=[1, 1, 1]),
                  (2, 16, 16, 1)),
    "imspec": (lambda: J.models.ImSpec((16, 16), (8,), latent_dim=2,
                                       nbfilters_encoder=4,
                                       nbfilters_decoder=4),
               (2, 16, 16)),
    "reg": (lambda: J.models.Regressor("mobilenet-slim", 2), (2, 16, 16, 1)),
    "cls": (lambda: J.models.Classifier("vgg-slim", 3), (2, 16, 16, 1)),
    "denoiser": (lambda: J.models.DenoisingAutoencoder(
        encoder_filters=[4, 8], decoder_filters=[8, 4],
        encoder_layers=[1, 1], decoder_layers=[1, 1], use_batch_norm=True),
        (2, 16, 16, 1)),
}


@pytest.mark.parametrize("name", sorted(SUPERVISED))
def test_load_model_of_jax_checkpoint(name, tmp_path):
    make, shape = SUPERVISED[name]
    jm = make()
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    jm.params, jm.batch_stats = _variables(jm.net, x)
    jm.batch_stats = jm.batch_stats or None
    path = jm.save_model(str(tmp_path / name))
    assert path.endswith(".aoi")
    want = _jax_forward(jm.net, jm.params, jm.batch_stats, x)
    pm = load_model(path, **CPU)
    assert pm.meta_state_dict["model_type"] == jm.meta_state_dict[
        "model_type"]
    with torch.no_grad():
        got = pm.forward(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _scaled(got, want) <= TOL_FWD
    # the typed loader and load_weights read it too, and a (meta, arrays)
    # pair and a {"meta", "arrays"} dict are sources as in the JAX package
    typed = {"unet": "load_seg_model", "segresnet": "load_seg_model",
             "imspec": "load_imspec_model", "reg": "load_reg_model",
             "cls": "load_cls_model",
             "denoiser": "load_denoising_autoencoder"}[name]
    pair = checkpoint.load_checkpoint(path)
    for source in (path, pair, {"meta": pair[0], "arrays": pair[1]}):
        m2 = getattr(__import__("atomai_tpu_torch").models, typed)(
            source, **CPU)
        with torch.no_grad():
            np.testing.assert_array_equal(
                m2.forward(torch.from_numpy(x)).numpy(), got)
    fresh = load_model(path, **CPU)
    with torch.no_grad():
        for p in fresh.net.parameters():
            p.zero_()
    fresh.load_weights(path)
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh.forward(torch.from_numpy(x)).numpy(), got)


VAES = {
    "vae": lambda: J.models.VAE((8, 8), latent_dim=2, numhidden_encoder=16,
                                numhidden_decoder=16),
    "rvae": lambda: J.models.rVAE((8, 8), latent_dim=2, numhidden_encoder=16,
                                  numhidden_decoder=16, translation=False),
    "jvae_conv": lambda: J.models.jVAE((8, 8), latent_dim=2,
                                       discrete_dim=[3], conv_encoder=True,
                                       conv_decoder=True,
                                       numhidden_encoder=4,
                                       numhidden_decoder=4),
    "jrvae": lambda: J.models.jrVAE((8, 8), latent_dim=2, discrete_dim=[3],
                                    numhidden_encoder=16,
                                    numhidden_decoder=16),
}


@pytest.mark.parametrize("name", sorted(VAES))
def test_load_model_of_jax_vae(name, tmp_path):
    jm = VAES[name]()
    jm._init_params()
    rng = np.random.RandomState(2)
    jm.params = jax.tree.map(
        lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32), jm.params)
    jm.num_iter, jm.current_epoch = 37, 4
    jm.metadict.update(num_iter=37, num_epochs=4)
    path = jm.save_model(str(tmp_path / name))
    pm = load_model(path, **CPU)
    assert type(pm).__name__ == type(jm).__name__
    assert (pm.num_iter, pm.current_epoch) == (37, 4)
    assert pm.metadict["num_iter"] == 37
    x = rng.rand(6, 8, 8).astype(np.float32)
    zdim = 2 + sum(jm.metadict.get("discrete_dim") or [])
    z = rng.randn(5, zdim).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jm.encode(x)
        dec_want = jm.decode(z)
    got = pm.encode(x)
    for g, w in zip(got, want):
        assert _scaled(g, w) <= TOL_FWD
    assert _scaled(pm.decode(z), dec_want) <= TOL_FWD
    # the JAX package's "weights" file loads into a built model
    wpath = jm.save_weights(str(tmp_path / f"{name}_w"))
    pm2 = load_model(path, **CPU)
    with torch.no_grad():
        for p in list(pm2.encoder_net.parameters()) + list(
                pm2.decoder_net.parameters()):
            p.zero_()
    pm2.load_weights(wpath)
    for g, w in zip(pm2.encode(x), got):
        np.testing.assert_array_equal(g, w)


def test_dkl_fe_weights_of_jax(tmp_path):
    from atomai_tpu.nets.gp import fcFeatureExtractor
    from atomai_tpu_torch.trainers import dklGPTrainer
    X = np.random.RandomState(3).randn(40, 6).astype(np.float32)
    y = X[:, 0].astype(np.float32)
    net = fcFeatureExtractor(6, 2)
    params = jax.tree.map(
        lambda a: (np.random.RandomState(4).randn(*a.shape) * 0.05
                   ).astype(np.float32),
        dict(net.init(jax.random.key(0), jnp.zeros((1, 6))))["params"])
    path = jax_save(str(tmp_path / "fe"), {"model_type": "dkl_fe"},
                    {"params": params})
    t = dklGPTrainer(6, 2, **CPU)
    t.compile_trainer(X, y, 1)
    t.load_weights(path)
    with torch.no_grad():
        got = t.fe(torch.from_numpy(X)).numpy()
    assert _scaled(got, net.apply({"params": params}, X)) <= TOL_FWD


# ------------------------------------------------------------ ensembles
@pytest.mark.parametrize("member_stats", [True, False])
def test_load_ensemble_of_jax(member_stats, tmp_path):
    et = J.trainers.EnsembleTrainer("Unet", 1, nb_filters=4,
                                    layers=[1, 1, 1, 1])
    x = np.random.RandomState(5).rand(2, 16, 16, 1).astype(np.float32)
    members = {i: _variables(et.net, x, seed=10 + i) for i in range(3)}
    base_p, base_s = _variables(et.net, x, seed=20)
    et.params, et.batch_stats = base_p, base_s
    et.ensemble_state_dict = {i: p for i, (p, _) in members.items()}
    if member_stats:
        et.ensemble_batch_stats = {i: s for i, (_, s) in members.items()}
    path = et.save_ensemble_metadict(str(tmp_path / "e"))
    net, ens = load_ensemble(path, **CPU)
    assert sorted(ens) == [0, 1, 2]
    for i, (p, s) in members.items():
        want = _jax_forward(et.net, p, s if member_stats else base_s, x)
        net.load_state_dict(ens[i])
        with torch.no_grad():
            got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).numpy()
        assert _scaled(got, want) <= TOL_FWD
    _, jens = J.models.load_ensemble(path)
    assert sorted(jens) == sorted(ens)


# --------------------------------------------------------------- resume
def test_resume_training_from_jax_adam_state(tmp_path):
    imgs, masks, _ = J.utils.make_lattice_stack(n_images=6, size=32,
                                               spacing=8, seed=0)
    data = (imgs[:4], masks[:4], imgs[4:], masks[4:])
    jm = J.models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1])
    with jax.default_matmul_precision("highest"):
        jm.fit(*data, training_cycles=3, batch_size=2, print_loss=3,
               filename=str(tmp_path / "j"), mesh=False)
        path = jm.save_model(str(tmp_path / "opt"), include_optimizer=True)
        jm.resume_training(path, additional_cycles=3)
    want = {k: np.asarray(jm.loss_acc[k][-3:]) for k in ("train_loss",
                                                         "test_loss")}
    pm = load_model(path, **CPU)
    pm.compile_trainer(data, training_cycles=3, batch_size=2, print_loss=3,
                       filename=str(tmp_path / "p"))
    _, arrays = checkpoint.load_checkpoint(path)
    state = pm._jax_optimizer_state(arrays)
    adam = arrays["opt_state"]["0"]
    assert float(state[0]["step"]) == float(adam["count"]) == 3
    names = [n for n, _ in pm.net.named_parameters()]
    w = state[names.index("c1.block.0.weight")]["exp_avg_sq"]
    np.testing.assert_array_equal(
        w.numpy(), adam["nu"]["ConvBlock_0"]["Conv_0"]["kernel"].transpose(
            3, 2, 0, 1))
    pm.resume_training(path, additional_cycles=3)
    assert pm.num_steps == 6
    np.testing.assert_array_equal(pm.batch_idx_train, jm.batch_idx_train)
    for k, v in want.items():
        np.testing.assert_allclose(pm.loss_acc[k], v, rtol=RTOL_LOSS,
                                   err_msg=k)
