"""The port's weight and class utilities and its profiling helpers on the
CPU, against the JAX package's where both compute the same thing:
``num_params`` of the same nets (the JAX side's shapes from
``jax.eval_shape``), ``combine_classes`` / ``renumerate_classes``
(exact), ``set_train_rng``'s numpy seeding (exact), ``reset_bnorm``; and
the port's own contracts: Xavier bounds and zero biases of
``weights_init`` (torch's fans; on a linear layer they are the JAX
package's), ``mock_forward`` / ``get_nb_classes`` /
``get_downsample_factor`` in the port's NCHW layout, ``gpu_usage_map``,
and a ``trace`` with an ``annotate``d region.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from atomai_tpu import nets as jnets
from atomai_tpu.utils import nn as jnn
from atomai_tpu_torch import nets
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.utils import nn as tnn

torch.set_num_threads(1)

NETS = {
    "Unet": dict(nb_classes=3, nb_filters=8),
    "dilnet": dict(nb_classes=1, nb_filters=8),
    "SegResNet": dict(nb_classes=2, nb_filters=8),
    "ResHedNet": dict(nb_classes=1, nb_filters=8),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_num_params_matches_jax(name):
    kw = NETS[name]
    net = getattr(jnets, name)(**kw)
    shapes = jax.eval_shape(
        lambda k: net.init({"params": k, "dropout": k},
                           jnp.zeros((1, 32, 32, 1)), False),
        jax.random.key(0))
    assert tnn.num_params(getattr(nets, name)(**kw)) == \
        jnn.num_params(shapes["params"])


def _coords(seed=0):
    rng = np.random.RandomState(seed)
    return {i: np.concatenate([rng.rand(20, 2) * 64,
                               rng.choice([1, 3, 4, 7], (20, 1))], 1)
            for i in range(3)}


@pytest.mark.parametrize("renumerate", [True, False])
@pytest.mark.parametrize("combine", [[[3, 4]], [[1, 7], [3, 4]], [[7, 1]]])
def test_combine_classes_matches_jax(combine, renumerate):
    c = _coords()
    got = tnn.combine_classes(c, combine, renumerate)
    want = jnn.combine_classes(c, combine, renumerate)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert all(np.array_equal(c[k], _coords()[k]) for k in c)  # untouched


@pytest.mark.parametrize("start_from_1", [True, False])
def test_renumerate_classes_matches_jax(start_from_1):
    c = _coords(1)
    got = tnn.renumerate_classes(c, start_from_1)
    want = jnn.renumerate_classes(c, start_from_1)
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert np.array_equal(tnn.renumerate_classes_(c[0], start_from_1),
                          jnn.renumerate_classes_(c[0], start_from_1))


def test_set_train_rng_seeds_numpy_and_returns_a_generator():
    g = tnn.set_train_rng(5)
    a = np.random.rand(4)
    jnn.set_train_rng(5)
    assert np.array_equal(a, np.random.rand(4))
    assert isinstance(g, torch.Generator) and g.initial_seed() == 5
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=tnn.set_train_rng(5)))


def test_weights_init_draws_xavier_weights_and_zero_biases():
    net = nets.Unet(nb_classes=2, nb_filters=8)
    bn_before = {k: v.clone() for k, v in net.state_dict().items()
                 if ".bn" in k or "norm" in k}
    out = tnn.weights_init(net, torch.Generator().manual_seed(0))
    assert out is net
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    for m in convs:
        fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(m.weight)
        bound = math.sqrt(6 / (fan_in + fan_out))
        w = m.weight.detach()
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
        assert torch.count_nonzero(m.bias) == 0
    for k, v in bn_before.items():
        assert torch.equal(net.state_dict()[k], v)
    again = tnn.weights_init(nets.Unet(nb_classes=2, nb_filters=8),
                             torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(net.parameters(), again.parameters()))


def test_weights_init_bound_of_a_linear_layer_matches_jax():
    """On a dense layer torch's fans are the JAX package's: the draws of
    both lie within the same Xavier bound and fill it."""
    lin = nn.Linear(40, 24)
    tnn.weights_init(lin, torch.Generator().manual_seed(1))
    params = {"Dense_0": {"kernel": jnp.ones((40, 24)),
                          "bias": jnp.ones(24)}}
    jw = jnn.weights_init(jax.random.key(0), params)["Dense_0"]
    bound = math.sqrt(6 / 64)
    for w in (lin.weight.detach().numpy(), np.asarray(jw["kernel"])):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert not np.asarray(jw["bias"]).any() and not lin.bias.any()


def test_reset_bnorm_matches_jax():
    net = nets.Unet(nb_classes=1, nb_filters=4)
    net.train()
    net(torch.randn(2, 1, 16, 16))
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    assert any(m.running_mean.abs().sum() > 0 for m in bns)
    assert tnn.reset_bnorm(net) is net
    stats = {"bn": {"mean": jnp.full(3, 2.0), "var": jnp.full(3, 5.0)}}
    jstats = jnn.reset_bnorm(stats)["bn"]
    for m in bns:
        assert torch.equal(m.running_mean,
                           torch.zeros_like(m.running_mean))
        assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    assert np.array_equal(jstats["mean"], np.zeros(3))
    assert np.array_equal(jstats["var"], np.ones(3))


class _Custom(nn.Module):
    """A user's net with no ``nb_classes``: halves, then doubles."""

    def __init__(self, out=4):
        super().__init__()
        self.down = nn.Conv2d(1, 8, 3, stride=2, padding=1)
        self.up = nn.ConvTranspose2d(8, out, 2, stride=2)

    def forward(self, x):
        return self.up(torch.relu(self.down(x)))


def test_mock_forward_and_class_and_downsample_queries():
    net = nets.Unet(nb_classes=3, nb_filters=4)
    net.train()
    out = tnn.mock_forward(net, dims=(16, 24))
    assert out.shape == (1, 3, 16, 24) and net.training
    assert tnn.get_nb_classes(net) == 3
    custom = _Custom(out=5)
    assert tnn.get_nb_classes(custom) == 5
    for name, factor in (("Unet", 8), ("dilnet", 2), ("SegResNet", 4),
                         ("ResHedNet", 4)):
        assert tnn.get_downsample_factor(
            getattr(nets, name)(**NETS[name])) == factor
        assert factor == jnets.fcnn.DOWNSAMPLE_FACTORS[name]
    assert tnn.get_downsample_factor(custom) == 8


def test_gpu_usage_map_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tnn.gpu_usage_map() == {"cpu": {"bytes_in_use": None}}
    assert set(next(iter(jnn.gpu_usage_map().values()))) <= {
        "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
