"""The original atomai's checkpoints (``.tar`` metadicts of a torch
``state_dict``) load into the port as they load into the JAX package.

The reference package is not installed: each test writes a
reference-keyed state dict whose keys follow the JAX package's own
conversion tables (``atomai_tpu.models.conversion``: the FCNN block maps,
``_imspec_mapping``, ``_vae_encoder_mapping``, ``_vae_decoder_mapping``,
``_denoiser_mapping``, ``_BACKBONE_SPECS``), with the layer shapes of the
JAX net, in torch's layouts (OIHW, (out, in)), values drawn from a numpy
seed. Both packages' ``load_torch_checkpoint`` read the same file; their
forwards must agree within 1e-5 of the output's scale (float32 on the
CPU, the same weights; measured <= 1e-6), which holds the port's copy of
the name maps and of the flatten relayouts against the JAX package's.
"""

import importlib.util
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

import atomai_tpu as J
from atomai_tpu.models import conversion as jconv
from atomai_tpu_torch.models import (load_pretrained_model,
                                     load_torch_checkpoint,
                                     load_torch_ensemble)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_fx_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()


def _shapes(net, x):
    flat = FX.variable_shapes(net, x)
    zeros = {k: np.zeros(tuple(v), np.float32) for k, v in flat.items()}
    return FX.unflatten(zeros, "params")


def _natural(d):
    def key(k):
        name, _, idx = k.rpartition("_")
        return (name, int(idx) if idx.isdigit() else 0)
    return sorted([k for k in d if isinstance(d[k], dict)], key=key)


def _layers(tree):
    """A flax module's conv/dense leaves and BatchNorms, in the order the
    JAX package pairs them with torch layers."""
    convs, bns = [], []

    def walk(d):
        for k in _natural(d):
            if "kernel" in d[k]:
                convs.append(d[k])
            elif "scale" in d[k]:
                bns.append(d[k])
            else:
                walk(d[k])
    if "kernel" in tree:
        convs.append(tree)
    elif "scale" in tree:
        bns.append(tree)
    else:
        walk(tree)
    return convs, bns


_TORCH = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _reference_sd(params, mapping, rng):
    """A reference state_dict for ``mapping`` entries (torch prefix, flax
    path[, layout]) over the JAX ``params``' shapes."""
    sd = {}
    for entry in mapping:
        prefix, path = entry[0], entry[1]
        path = (path,) if isinstance(path, str) else tuple(path)
        tree = params
        for p in path:
            tree = tree[p]
        convs, bns = _layers(tree)
        leaf = "kernel" in tree or "scale" in tree
        for j, conv in enumerate(convs):
            shape = tuple(np.transpose(conv["kernel"],
                                       _TORCH[conv["kernel"].ndim]).shape)
            name = prefix if leaf else f"{prefix}.{j}"
            fan_in = int(np.prod(shape[1:]))
            sd[f"{name}.weight"] = torch.from_numpy(
                (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32))
            if "bias" in conv:
                sd[f"{name}.bias"] = torch.from_numpy(
                    (rng.randn(shape[0]) * 0.1).astype(np.float32))
        for j, bn in enumerate(bns):
            c = bn["scale"].shape[0]
            name = prefix if leaf else f"{prefix}.bn{j}"
            for k, v in (("weight", 1 + 0.1 * rng.randn(c)),
                         ("bias", 0.1 * rng.randn(c)),
                         ("running_mean", 0.1 * rng.randn(c)),
                         ("running_var", 0.5 + rng.rand(c))):
                sd[f"{name}.{k}"] = torch.from_numpy(v.astype(np.float32))
    return sd


def _jax_out(model, x):
    v = {"params": model.params}
    if getattr(model, "batch_stats", None):
        v["batch_stats"] = model.batch_stats
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda xx: model.net.apply(
            v, xx, False))(x))


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _port_out(model, x):
    with torch.no_grad():
        return model.forward(torch.from_numpy(x)).numpy()


SEG = {"unet": dict(model="Unet", nb_filters=4, layers=[1, 2, 1, 1]),
       "unet_dil": dict(model="Unet", nb_filters=4, layers=[1, 1, 1, 2],
                        with_dilation=True),
       "dilnet": dict(model="dilnet", nb_filters=4, layers=[1, 2, 2, 1]),
       "segresnet": dict(model="SegResNet", nb_filters=4,
                         layers=[1, 2, 1])}


@pytest.mark.parametrize("name", sorted(SEG))
def test_seg_checkpoint(name, tmp_path):
    from atomai_tpu.nets import init_fcnn_model
    kw = dict(SEG[name])
    model = kw.pop("model")
    x = np.random.RandomState(1).rand(2, 16, 16, 1).astype(np.float32)
    params = _shapes(init_fcnn_model(model, 2, **kw)[0], x)
    mapping = jconv._block_mapping(model, kw.get("with_dilation", False))
    sd = _reference_sd(params, mapping, np.random.RandomState(0))
    path = str(tmp_path / f"{name}.tar")
    torch.save({"model_type": "seg", "model": model, "nb_classes": 2,
                "weights": sd, **kw}, path)
    jm = jconv.load_torch_checkpoint(path)
    pm = load_torch_checkpoint(path, device="cpu")
    assert pm.meta_state_dict["model"] == model
    assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL


def test_imspec_checkpoint(tmp_path):
    from atomai_tpu.nets import init_imspec_model
    kw = dict(nbfilters_encoder=4, nbfilters_decoder=4,
              encoder_downsampling=2, decoder_upsampling=True)
    x = np.random.RandomState(1).rand(2, 16, 16).astype(np.float32)
    params = _shapes(init_imspec_model((16, 16), (16,), 2, **kw)[0], x)
    mapping = jconv._imspec_mapping(True, (16, 16), (16,), 4, 4, 2)
    sd = _reference_sd(params, mapping, np.random.RandomState(0))
    path = str(tmp_path / "imspec.tar")
    torch.save({"model_type": "imspec", "in_dim": (16, 16), "out_dim": (16,),
                "latent_dim": 2, "weights": sd, **kw}, path)
    jm = jconv.load_torch_checkpoint(path)
    pm = load_torch_checkpoint(path, device="cpu")
    assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL


VAES = {"vae_conv": dict(coord=0, conv_encoder=True, conv_decoder=True),
        "rvae": dict(coord=3), "jvae": dict(coord=0, discrete_dim=[3]),
        "jrvae": dict(coord=1, discrete_dim=[2])}


@pytest.mark.parametrize("name", sorted(VAES))
def test_vae_checkpoint(name, tmp_path):
    kw = VAES[name]
    meta = dict(model_type="vae", in_dim=(8, 8), latent_dim=2,
                numlayers_encoder=2, numlayers_decoder=1,
                numhidden_encoder=4 if kw.get("conv_encoder") else 16,
                numhidden_decoder=4 if kw.get("conv_decoder") else 16,
                nb_classes=0, **kw)
    n_disc = len(kw.get("discrete_dim") or ())
    cls = {(0, 0): "VAE", (1, 0): "rVAE", (0, 1): "jVAE",
           (1, 1): "jrVAE"}[(int(bool(kw["coord"])), int(bool(n_disc)))]
    args = dict(numlayers_encoder=2, numlayers_decoder=1,
                numhidden_encoder=meta["numhidden_encoder"],
                numhidden_decoder=meta["numhidden_decoder"],
                conv_encoder=kw.get("conv_encoder", False),
                conv_decoder=kw.get("conv_decoder", False))
    if kw["coord"]:
        args["translation"] = kw["coord"] == 3
    if n_disc:
        args["discrete_dim"] = kw["discrete_dim"]
    skel = getattr(J.models, cls)((8, 8), latent_dim=2, **args)
    skel._init_params()
    params = jax.tree.map(np.asarray, skel.params)
    rng = np.random.RandomState(0)
    enc = _reference_sd(params["encoder"], jconv._vae_encoder_mapping(
        kw.get("conv_encoder", False), 2, n_disc, (8, 8),
        meta["numhidden_encoder"]), rng)
    dec = _reference_sd(params["decoder"], jconv._vae_decoder_mapping(
        kw["coord"], kw.get("conv_decoder", False), 1, (8, 8),
        meta["numhidden_decoder"]), rng)
    path = str(tmp_path / f"{name}.tar")
    torch.save({**meta, "encoder": enc, "decoder": dec}, path)
    jm = jconv.load_torch_checkpoint(path)
    pm = load_torch_checkpoint(path, device="cpu")
    assert type(pm).__name__ == type(jm).__name__ == cls
    x = np.random.RandomState(1).rand(5, 8, 8).astype(np.float32)
    z = np.random.RandomState(2).randn(5, 2 + sum(
        kw.get("discrete_dim") or [])).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jm.encode(x), jm.decode(z)
    for g, w in zip(pm.encode(x), want[0]):
        assert _scaled(g, w) <= TOL
    assert _scaled(pm.decode(z), want[1]) <= TOL


def test_denoiser_checkpoint(tmp_path):
    from atomai_tpu.models.denoiser import DenoiserNet
    meta = dict(encoder_filters=[4, 8, 8], decoder_filters=[8, 8, 4],
                encoder_layers=[1, 2, 1], decoder_layers=[1, 1, 2],
                use_batch_norm=True)
    net = DenoiserNet((4, 8, 8), (8, 8, 4), (1, 2, 1), (1, 1, 2), True)
    x = np.random.RandomState(1).rand(2, 16, 16, 1).astype(np.float32)
    sd = _reference_sd(_shapes(net, x), jconv._denoiser_mapping(
        meta["encoder_filters"], meta["decoder_filters"]),
        np.random.RandomState(0))
    path = str(tmp_path / "den.tar")
    torch.save({"model_type": "denoising_autoencoder", "weights": sd,
                **meta}, path)
    jm = jconv.load_torch_checkpoint(path)
    pm = load_torch_checkpoint(path, device="cpu")
    assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL


@pytest.mark.parametrize("kind,backbone", [("reg", "mobilenet"),
                                           ("cls", "resnet")])
def test_reg_cls_checkpoint(kind, backbone, tmp_path):
    from atomai_tpu.nets import init_cls_model, init_reg_model
    out = 2 if kind == "reg" else 3
    net = (init_reg_model if kind == "reg" else init_cls_model)(
        out, backbone)[0]
    x = np.random.RandomState(1).rand(2, 32, 32, 1).astype(np.float32)
    params = _shapes(net, x)
    feats = params["ConvBackbone_0"]["features"]
    mapping = [(f"backbone.backbone_layers.{tk}",
                ("features",) + tuple(path))
               for tk, path, _ in jconv._BACKBONE_SPECS[backbone]()]
    rng = np.random.RandomState(0)
    sd = _reference_sd({"features": feats}, mapping, rng)
    head = "output_layer" if kind == "reg" else "output_layer.0"
    sd.update(_reference_sd(params, [(head, ("Dense_0",))], rng))
    path = str(tmp_path / f"{kind}.tar")
    meta = {"model_type": kind, "backbone": backbone, "in_channels": 1,
            ("out_dim" if kind == "reg" else "nb_classes"): out}
    torch.save({**meta, "weights": sd}, path)
    jm = jconv.load_torch_checkpoint(path)
    pm = load_torch_checkpoint(path, device="cpu")
    assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL


def _seg_tar(path, seed, members=None):
    from atomai_tpu.nets import init_fcnn_model
    kw = dict(nb_filters=4, layers=[1, 1, 1, 1])
    x = np.zeros((1, 16, 16, 1), np.float32)
    params = _shapes(init_fcnn_model("Unet", 1, **kw)[0], x)
    mapping = jconv._block_mapping("Unet", False)
    if members is None:
        weights = _reference_sd(params, mapping, np.random.RandomState(seed))
    else:
        weights = {i: _reference_sd(params, mapping,
                                    np.random.RandomState(seed + i))
                   for i in range(members)}
    torch.save({"model_type": "seg", "model": "Unet", "nb_classes": 1,
                "weights": weights, **kw}, path)
    return path


def test_ensemble_checkpoint(tmp_path):
    path = _seg_tar(str(tmp_path / "ens.tar"), 3, members=3)
    jm, stacked = jconv.load_torch_ensemble(path)
    pm, members = load_torch_ensemble(path, device="cpu")
    assert sorted(members) == [0, 1, 2]
    x = np.random.RandomState(1).rand(2, 16, 16, 1).astype(np.float32)
    assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL
    # the JAX package stacks the members' params only (its model keeps the
    # last member's BatchNorm statistics); the port's members keep their
    # own, which are the file's
    ref = torch.load(path, weights_only=False)["weights"]
    buffers = {n for n, _ in pm.net.named_buffers()}
    for i in members:
        np.testing.assert_array_equal(
            members[i]["c1.block.2.running_mean"],
            ref[i]["c1.bn0.running_mean"])
        jm.params = jax.tree.map(lambda a: a[i], stacked)
        pm.net.load_state_dict({k: members[2][k] if k in buffers else v
                                for k, v in members[i].items()})
        assert _scaled(_port_out(pm, x), _jax_out(jm, x)) <= TOL


def test_pretrained_model_without_network(tmp_path, monkeypatch):
    """The download is replaced by a function that writes a local file."""
    fetched = []

    def fake_urlretrieve(url, filename):
        fetched.append(url)
        _seg_tar(filename, 7)
        return filename, None

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    monkeypatch.chdir(tmp_path)
    m = load_pretrained_model("BFO", device="cpu")
    assert fetched and fetched[0].endswith("bfo.tar?raw=true")
    assert os.path.exists(tmp_path / "bfo.tar")
    assert m.meta_state_dict["model"] == "Unet"
    with pytest.raises(ValueError, match="G_MD"):
        load_pretrained_model("other", device="cpu")
