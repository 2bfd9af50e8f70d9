"""The port's Unet and its blocks against the JAX package's flax modules,
with the same weights carried over by ``unet_from_jax``.

Both run in float32 on the CPU; the tolerance (atol 1e-5 on outputs of
magnitude ~1) covers summation order only.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.nets import Unet as JaxUnet
from atomai_tpu.nets.blocks import ConvBlock as JaxConvBlock
from atomai_tpu.nets.blocks import UpsampleBlock as JaxUpsampleBlock
from atomai_tpu_torch.models import Segmentor, unet_from_jax
from atomai_tpu_torch.models import conversion
from atomai_tpu_torch.nets import ConvBlock, Unet, UpsampleBlock

torch.set_num_threads(1)

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_init(net, x, seed=0):
    variables = jax.device_get(net.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed)},
        jnp.asarray(x), False))
    return jax.tree.map(np.asarray, dict(variables))


def _random_stats(stats, seed=1):
    """BatchNorm statistics away from the identity, so that the mapping of
    mean and var is exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (0.5 + rng.rand(*a.shape)).astype(np.float32), stats)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (1, 2, 2, 3)])
@pytest.mark.parametrize("shape", [(2, 32, 32), (2, 40, 24)])
def test_unet_matches_flax(layers, shape):
    x = np.random.RandomState(0).rand(*shape, 1).astype(np.float32)
    jnet = JaxUnet(nb_classes=1, nb_filters=4, layers=layers)
    v = _jax_init(jnet, x)
    stats = _random_stats(v["batch_stats"])
    y = np.asarray(jnet.apply({"params": v["params"], "batch_stats": stats},
                              jnp.asarray(x), False))
    net = Unet(nb_classes=1, nb_filters=4, layers=layers)
    net.load_state_dict(unet_from_jax(v["params"], stats))
    net.eval()
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == y.shape
    np.testing.assert_allclose(got, y, atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    {"dropout": True},                       # shifts the Sequential indices
    {"batch_norm": False},                   # no BatchNorm layers at all
    {"nb_classes": 3},                       # multi-class head
    {"upsampling_mode": "nearest"},
])
def test_unet_variants_match_flax(kwargs):
    x = np.random.RandomState(2).rand(2, 24, 32, 1).astype(np.float32)
    nb = kwargs.pop("nb_classes", 1)
    jnet = JaxUnet(nb_classes=nb, nb_filters=4, **kwargs)
    v = _jax_init(jnet, x, seed=3)
    stats = _random_stats(v.get("batch_stats", {}))
    variables = {"params": v["params"]}
    if stats:
        variables["batch_stats"] = stats
    y = np.asarray(jnet.apply(variables, jnp.asarray(x), False))
    net = Unet(nb_classes=nb, nb_filters=4, **kwargs)
    net.load_state_dict(unet_from_jax(v["params"], stats,
                                      dropout=kwargs.get("dropout", False)))
    net.eval()
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    np.testing.assert_allclose(got, y, atol=ATOL)


@pytest.mark.parametrize("nb_layers,batch_norm", [(1, False), (2, True),
                                                  (3, True)])
def test_conv_block_matches_flax(nb_layers, batch_norm):
    x = np.random.RandomState(4).randn(2, 20, 28, 3).astype(np.float32)
    jblock = JaxConvBlock(2, nb_layers, 8, batch_norm=batch_norm)
    v = _jax_init(jblock, x)
    stats = _random_stats(v.get("batch_stats", {}))
    variables = {"params": v["params"]}
    if stats:
        variables["batch_stats"] = stats
    y = np.asarray(jblock.apply(variables, jnp.asarray(x), False))
    block = ConvBlock(2, nb_layers, 3, 8, batch_norm=batch_norm)
    block.load_state_dict(conversion._conv_block(v["params"], stats, False,
                                                 "ConvBlock"))
    block.eval()
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    np.testing.assert_allclose(got, y, atol=ATOL)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (1, 5, 9, 6)])
def test_upsample_block_matches_flax(mode, shape):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jblock = JaxUpsampleBlock(2, 4, mode=mode)
    params = jax.device_get(jblock.init(jax.random.key(0),
                                        jnp.asarray(x)))["params"]
    y = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = UpsampleBlock(2, shape[-1], 4, mode=mode)
    conv = conversion._conv(params["Conv_0"], "UpsampleBlock")
    block.load_state_dict({f"conv.{k}": t for k, t in conv.items()})
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    assert got.shape == y.shape
    np.testing.assert_allclose(got, y, atol=ATOL)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape", [(2, 8, 6), (1, 13, 3)])
def test_upsample_block_1d_matches_flax(mode, shape):
    """1D input: nearest interpolation whatever the mode, then a 1x1
    Conv1d (`atomai_tpu/nets/blocks.py:150-161`)."""
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    jblock = JaxUpsampleBlock(1, 4, mode=mode)
    params = jax.device_get(jblock.init(jax.random.key(0),
                                        jnp.asarray(x)))["params"]
    y = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = UpsampleBlock(1, shape[-1], 4, mode=mode)
    assert isinstance(block.conv, torch.nn.Conv1d)
    conv = conversion._conv(params["Conv_0"], "UpsampleBlock", rank=3)
    block.load_state_dict({f"conv.{k}": t for k, t in conv.items()})
    with torch.no_grad():
        got = block(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    got = got.permute(0, 2, 1).numpy()
    assert got.shape == y.shape == (shape[0], 2 * shape[1], 4)
    np.testing.assert_allclose(got, y, atol=ATOL)


@pytest.fixture(scope="module")
def small_unet_variables():
    x = np.zeros((1, 16, 16, 1), np.float32)
    v = _jax_init(JaxUnet(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1)),
                  x)
    return v["params"], v["batch_stats"]


def _copy(tree):
    return jax.tree.map(np.array, tree)


def _break_kernel_rank(p, s):
    p["ConvBlock_0"]["Conv_0"]["kernel"] = \
        p["ConvBlock_0"]["Conv_0"]["kernel"][0]


def _break_bias(p, s):
    p["UpsampleBlock_1"]["Conv_0"]["bias"] = np.zeros(3, np.float32)


def _break_bn_scale(p, s):
    p["ConvBlock_2"]["BatchNorm_0"]["scale"] = np.ones(5, np.float32)


def _drop_bn_stats(p, s):
    del s["ConvBlock_4"]["BatchNorm_0"]["var"]


def _add_dilated_block(p, s):
    p["DilatedBlock_0"] = p.pop("ConvBlock_3")


@pytest.mark.parametrize("breakage,match", [
    (_break_kernel_rank, "4D HWIO kernel"),
    (_break_bias, "bias shape"),
    (_break_bn_scale, "'scale' has shape"),
    (_drop_bn_stats, "missing BatchNorm 'var'"),
    (_add_dilated_block, "not the params of a plain JAX Unet"),
])
def test_bridge_rejects_bad_trees(small_unet_variables, breakage, match):
    params, stats = map(_copy, small_unet_variables)
    breakage(params, stats)
    with pytest.raises(ValueError, match=match):
        unet_from_jax(params, stats)


def test_bridge_width_mismatch_raises(small_unet_variables):
    """Variables of a 4-filter Unet do not load into a 16-filter one."""
    m = Segmentor("Unet", nb_classes=1, nb_filters=16, layers=(1, 1, 1, 1),
                  device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        m.load_jax_variables(*small_unet_variables)


def _fixture_script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_torch_port_fixtures",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_unet_fixture_is_current_and_port_matches_it():
    """The card's fixture equals a fresh JAX run (so it cannot go stale),
    and the full-width port Unet reproduces its output in float32."""
    script = _fixture_script()
    stored = dict(np.load(script.FIXTURE))
    fresh = script.make_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k == "y":
            # XLA:CPU's float32 convs on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], atol=1e-6)
        else:
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    net = Unet(nb_classes=1, nb_filters=16, layers=(1, 2, 2, 3))
    net.load_state_dict(unet_from_jax(script.unflatten(stored, "params"),
                                      script.unflatten(stored,
                                                       "batch_stats")))
    net.eval()
    with torch.no_grad():
        got = _nhwc(net(_nchw(stored["x"])))
    np.testing.assert_allclose(got, stored["y"], atol=ATOL)
