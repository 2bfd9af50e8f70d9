"""The supervised model zoo's nets against the JAX package's, on the same
weights (carried by ``fcnn_from_jax``, ``denoiser_from_jax`` and
``reg_cls_from_jax``): dilnet, SegResNet, ResHedNet and the dilated Unet,
the denoiser, the ResNet50 / VGG16 / MobileNetV2 backbones and the slim
presets, the regression, classification and multitask heads; the
metadicts, the bridges' refusals and the backbones' init.

Stated tolerances, float32 on the CPU (XLA:CPU ignores the JAX package's
bf16 matmul setting), each over the JAX output's largest |value|:
- eval mode: 1e-5 (measured <= 3.2e-7 on the segmentation nets); the full
  backbones, with He-scaled kernels and random running statistics that
  amplify rounding through up to 53 layers, 1e-4 (measured <= 2.9e-5,
  MobileNetV2);
- train mode (batch statistics): 1e-4 (measured <= 3.2e-5: ResHedNet's
  one-channel score BatchNorms divide by the spread of a nearly flat map);
  the full backbones 1e-3 (measured <= 6.4e-4: ResNet50's 53 train-mode
  BatchNorms over 4 x 2 x 2 values in the last stage);
- BatchNorm statistics after one train-mode forward: running means to the
  forward's tolerance over their largest |value| (the means of activations
  that differ by that much); running variances 1 / (n - 1) relative, n the
  smallest count
  a BatchNorm of the net averages over (batch x height x width), since
  flax updates the running variance with the biased batch variance and
  torch with the unbiased one (n / (n - 1)).
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.models.denoiser import DenoiserNet as JaxDenoiserNet
from atomai_tpu.nets import init_fcnn_model as jax_init_fcnn_model
from atomai_tpu.nets import reg_cls as jax_reg_cls
from atomai_tpu_torch import nets
from atomai_tpu_torch.models import (denoiser_from_jax, fcnn_from_jax,
                                     init_denoising_autoencoder,
                                     reg_cls_from_jax)

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TOL_EVAL = 1e-5
TOL_TRAIN = 1e-4
TOL_TRAIN_BACKBONE = 1e-3
TOL_EVAL_BACKBONE = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(dict(tree)))


def _seeded(jnet, x, gain=1.0):
    """numpy-drawn variables of ``jnet`` (no JAX initialiser runs):
    (params, batch_stats)."""
    script = chip_smoke.fixture_script()
    v = script.seeded_variables(script.variable_shapes(jnet, x),
                                kernel_gain=gain)
    return script.unflatten(v, "params"), script.unflatten(v,
                                                            "batch_stats")


def _scaled(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run_both(jnet, tnet, params, stats, x, train):
    """(JAX output, port output, JAX's updated statistics) on NHWC ``x``;
    the port's net takes NCHW."""
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, upd = jax.jit(lambda v, x: jnet.apply(
            v, x, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
        upd = _np(upd["batch_stats"])
    else:
        want, upd = jax.jit(lambda v, x: jnet.apply(v, x, False))(
            variables, jnp.asarray(x)), None
    tnet.train(train)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    return want, got, upd


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy() if y.ndim == 4 else y.numpy()


def _assert_stats(tnet, bridge, params, upd, n_min, rtol_mean=TOL_TRAIN):
    """The port's running statistics after the train-mode forward against
    the JAX package's updated ones."""
    want = bridge(params, upd)
    for k, t in tnet.state_dict().items():
        if k.endswith("running_mean"):
            assert _scaled(t.numpy(), want[k].numpy()) <= rtol_mean, k
        elif k.endswith("running_var"):
            np.testing.assert_allclose(t, want[k], rtol=1 / (n_min - 1),
                                       err_msg=k)


FCNN = {
    "unet_dilated": ("Unet", dict(nb_filters=4, layers=[1, 2, 2, 3],
                                  with_dilation=True)),
    "unet_dilated_nearest": ("Unet", dict(nb_filters=4, layers=[1, 1, 2, 2],
                                          with_dilation=True,
                                          upsampling="nearest")),
    "unet_dilated_dropout": ("Unet", dict(nb_filters=4, layers=[1, 1, 1, 2],
                                          with_dilation=True, dropout=True)),
    "dilnet": ("dilnet", dict(nb_filters=4, layers=[1, 2, 3, 1])),
    "dilnet_dropout": ("dilnet", dict(nb_filters=4, layers=[1, 2, 2, 1],
                                      dropout=True)),
    "segresnet": ("SegResNet", dict(nb_filters=4, layers=[1, 2, 1])),
    "segresnet_no_bn": ("SegResNet", dict(nb_filters=4, layers=[1, 1, 1],
                                          batch_norm=False)),
    "reshednet": ("ResHedNet", dict(nb_filters=4, layers=[1, 2, 1])),
    "reshednet_nearest": ("ResHedNet", dict(nb_filters=4, layers=[1, 1, 2],
                                            upsampling="nearest")),
}
# the smallest BatchNorm count of each net at batch 3 of 32 x 32: the
# Unet's bottleneck at 1/8, dilnet at 1/2, the others at 1/4
DOWN = {"Unet": 8, "dilnet": 2, "SegResNet": 4, "ResHedNet": 4}


# dropout draws differ between the packages: those nets in eval mode only
FCNN_RUNS = [(c, n, t) for c in sorted(FCNN) for n in (1, 3)
             for t in (False, True)
             if (n == 1 or c in ("unet_dilated", "dilnet", "segresnet",
                                 "reshednet"))
             and not (t and "dropout" in c)]


@pytest.mark.parametrize("case,nb_classes,train", FCNN_RUNS)
def test_fcnn_nets_match_jax(case, nb_classes, train):
    """ResHedNet's x2 and x4 score maps go through ``jax.image.resize``
    ("linear" or "nearest") in JAX and ``F.interpolate`` here."""
    model, kw = FCNN[case]
    jnet, jmeta = jax_init_fcnn_model(model, nb_classes, **kw)
    tnet, tmeta = nets.init_fcnn_model(model, nb_classes, **kw)
    assert tmeta == jmeta
    x = np.random.RandomState(0).rand(3, 32, 32, 1).astype(np.float32)
    params, stats = _seeded(jnet, x)
    bridge = lambda p, s: fcnn_from_jax(p, s, tmeta)  # noqa: E731
    tnet.load_state_dict(bridge(params, stats), strict=True)
    want, got, upd = _run_both(jnet, tnet, params, stats, x, train)
    assert got.shape == (3, nb_classes, 32, 32)
    err = _scaled(_nhwc(got), np.asarray(want))
    assert err <= (TOL_TRAIN if train else TOL_EVAL), err
    if train and stats:
        _assert_stats(tnet, bridge, params, upd,
                      3 * (32 // DOWN[model]) ** 2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["no_bn", "bn"])
def test_denoiser_net_matches_jax(batch_norm, train):
    """The default widths; BatchNorm on exercises its bridge."""
    jnet = JaxDenoiserNet(use_batch_norm=batch_norm)
    tnet, meta = init_denoising_autoencoder(use_batch_norm=batch_norm)
    x = np.random.RandomState(1).rand(3, 32, 32, 1).astype(np.float32)
    params, stats = _seeded(jnet, x)
    bridge = lambda p, s: denoiser_from_jax(p, s, meta)  # noqa: E731
    tnet.load_state_dict(bridge(params, stats), strict=True)
    want, got, upd = _run_both(jnet, tnet, params, stats, x, train)
    err = _scaled(_nhwc(got), np.asarray(want))
    assert err <= (TOL_TRAIN if train else TOL_EVAL), err
    if train and batch_norm:
        _assert_stats(tnet, bridge, params, upd, 3 * 4 * 4)


def _reg_cls_pair(kind, backbone, out):
    init = {"reg": "init_reg_model", "cls": "init_cls_model",
            "mtask": "init_mtask_cls_model"}[kind]
    jnet, jmeta = getattr(jax_reg_cls, init)(out, backbone)
    tnet, tmeta = getattr(nets, init)(out, backbone)
    assert tmeta == jmeta
    return jnet, tnet, tmeta


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backbone", ["resnet", "vgg", "mobilenet"])
def test_full_backbones_match_jax(backbone, train):
    """One full-topology forward per backbone, with He-scaled seeded
    kernels so that every layer counts; the regression head on top."""
    jnet, tnet, meta = _reg_cls_pair("reg", backbone, 2)
    x = np.random.RandomState(2).rand(4, 64, 64, 1).astype(np.float32)
    params, stats = _seeded(jnet, x, gain=math.sqrt(6))
    bridge = lambda p, s: reg_cls_from_jax(p, s, meta)  # noqa: E731
    tnet.load_state_dict(bridge(params, stats), strict=True)
    want, got, upd = _run_both(jnet, tnet, params, stats, x, train)
    err = _scaled(got.numpy(), np.asarray(want))
    assert err <= (TOL_TRAIN_BACKBONE if train else TOL_EVAL_BACKBONE), err
    if train and stats:
        # the last stage's maps are 2 x 2 (1/32) for ResNet50 and
        # MobileNetV2
        _assert_stats(tnet, bridge, params, upd, 4 * 2 * 2,
                      TOL_TRAIN_BACKBONE)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backbone,kind,out", [
    ("mobilenet-slim", "reg", 2), ("resnet-slim", "cls", 3),
    ("vgg-slim", "mtask", [2, 3])])
def test_slim_backbones_and_heads_match_jax(backbone, kind, out, train):
    """The slim presets (the loop's BatchNorms in float32 under the mixed
    policy, as the JAX ones without ``dtype``) and the three heads: linear,
    log-softmax, one log-softmax per task."""
    jnet, tnet, meta = _reg_cls_pair(kind, backbone, out)
    x = np.random.RandomState(3).rand(4, 32, 32, 1).astype(np.float32)
    params, stats = _seeded(jnet, x)
    bridge = lambda p, s: reg_cls_from_jax(p, s, meta)  # noqa: E731
    tnet.load_state_dict(bridge(params, stats), strict=True)
    want, got, upd = _run_both(jnet, tnet, params, stats, x, train)
    if kind != "mtask":
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        err = _scaled(g.numpy(), np.asarray(w))
        assert err <= (TOL_TRAIN if train else TOL_EVAL), err
    if kind == "cls":
        np.testing.assert_allclose(got[0].exp().sum(1), 1, rtol=1e-5)
    if train:
        _assert_stats(tnet, bridge, params, upd, 4 * 1 * 1)


def test_torchvision_names_and_sizes():
    """The backbones carry torchvision's module names (so its state dicts
    load key for key) and the JAX topologies' parameter counts."""
    x = np.zeros((1, 64, 64, 1), np.float32)
    keys = {
        "resnet": ["conv1.weight", "bn1.running_var",
                   "layer1.0.downsample.0.weight", "layer3.5.conv3.weight",
                   "layer4.2.bn3.bias"],
        "vgg": ["0.weight", "2.bias", "5.weight", "28.weight"],
        "mobilenet": ["0.0.weight", "0.1.bias", "1.conv.0.0.weight",
                      "1.conv.1.weight", "2.conv.0.0.weight",
                      "2.conv.1.0.weight", "17.conv.3.running_mean",
                      "18.0.weight", "18.1.weight"]}
    for backbone, names in keys.items():
        features = nets.BACKBONE_FEATURES[backbone](1)
        sd = features.state_dict()
        assert all(k in sd for k in names), backbone
        jnet = jax_reg_cls.RegressorNet(1, 1, backbone)
        shapes = chip_smoke.fixture_script().variable_shapes(jnet, x)
        n_jax = sum(int(np.prod(s)) for k, s in shapes.items()
                    if k.startswith("params/ConvBackbone_0"))
        assert n_jax == sum(p.numel() for p in features.parameters())
    dw = nets.BACKBONE_FEATURES["mobilenet"](1)[2].conv[1][0]
    assert dw.groups == dw.in_channels == 96      # depthwise


@pytest.mark.parametrize("backbone", ["resnet", "vgg", "mobilenet",
                                      "vgg-slim"])
def test_backbone_init_distribution(backbone):
    """torchvision's init for the full backbones (the JAX package's
    ``_TV_CONV_INIT``): each conv's std within 10% of sqrt(2 / fan_out),
    biases 0, BatchNorm at identity; the slim presets and the head keep
    torch's default U(+-1/sqrt(fan_in))."""
    net, _ = nets.init_reg_model(1, backbone)
    nets.init_weights_(net, torch.Generator().manual_seed(0))
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    for conv in convs:
        w = conv.weight.detach()
        if backbone.endswith("-slim"):
            bound = 1 / math.sqrt(conv.in_channels * 9)
            assert float(w.abs().max()) <= bound
            assert float(w.std()) == pytest.approx(bound / math.sqrt(3),
                                                   rel=0.1)
            continue
        fan_out = conv.out_channels * math.prod(conv.kernel_size)
        assert float(w.std()) == pytest.approx(math.sqrt(2 / fan_out),
                                               rel=0.1)
        assert abs(float(w.mean())) < 4 * float(w.std()) / math.sqrt(
            w.numel())
        if conv.bias is not None:
            assert not conv.bias.any()
    for bn in (m for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d)):
        assert bn.weight.eq(1).all() and not bn.bias.any()
    head = net.output_layer
    assert float(head.weight.abs().max()) <= 1 / math.sqrt(head.in_features)
    # the same seed draws the same weights
    again, _ = nets.init_reg_model(1, backbone)
    nets.init_weights_(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 again.state_dict().values()))


def test_fcnn_metadicts_and_custom_module_match_jax():
    for model in ("Unet", "dilnet", "SegResNet", "ResHedNet"):
        for kw in ({}, {"dropout": True, "batch_norm": False,
                        "upsampling": "nearest"}):
            tnet, tmeta = nets.init_fcnn_model(model, 2, **kw)
            assert tmeta == jax_init_fcnn_model(model, 2, **kw)[1]
            assert nets.DOWNSAMPLE_FACTORS[type(tnet).__name__] == DOWN[model]
    custom = torch.nn.Conv2d(1, 1, 1)
    net, meta = nets.init_fcnn_model(custom, 1)
    assert net is custom
    assert meta == {"model_type": "seg", "model": "custom", "nb_classes": 1}
    with pytest.raises(NotImplementedError, match="Currently implemented"):
        nets.init_fcnn_model("FCN", 1)
    with pytest.raises(ValueError, match="backbone_type"):
        nets.ConvBackbone("alexnet")


def test_bridges_reject_trees_that_do_not_fit():
    x = np.zeros((1, 32, 32, 1), np.float32)
    jnet, jmeta = jax_init_fcnn_model("SegResNet", 1, nb_filters=4,
                                      layers=[1, 1, 1])
    params, stats = _seeded(jnet, x)
    with pytest.raises(ValueError, match="not the params of a JAX dilnet"):
        fcnn_from_jax(params, stats, dict(jmeta, model="dilnet"))
    with pytest.raises(ValueError, match="no weight bridge"):
        fcnn_from_jax(params, stats, {"model": "custom"})
    jnet, _ = jax_init_fcnn_model("Unet", 1, nb_filters=4,
                                  layers=[1, 1, 1, 1], with_dilation=True)
    params, stats = _seeded(jnet, x)
    with pytest.raises(ValueError, match="plain JAX Unet"):
        fcnn_from_jax(params, stats, {"model": "Unet"})
    net, meta = init_denoising_autoencoder()
    params, stats = _seeded(JaxDenoiserNet(), x)
    with pytest.raises(ValueError, match="denoiser"):
        denoiser_from_jax(params, stats, dict(
            meta, encoder_filters=[8, 16, 32]))
    jnet, _, meta = _reg_cls_pair("reg", "vgg-slim", 1)
    params, stats = _seeded(jnet, x)
    with pytest.raises(ValueError, match="ConvBackbone_0"):
        reg_cls_from_jax(params, stats, dict(meta, backbone="vgg"))
    with pytest.raises(ValueError, match="reg/cls"):
        reg_cls_from_jax(params, stats, dict(meta, model_type="cls",
                                             nb_classes=[2, 3]))
