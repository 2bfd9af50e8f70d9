"""The frozen copies against the program they were copied from, on the CPU:
the reference Unet, the generator, the labeller's byte count and the peaks,
the Locator, DBSCAN and cluster means, and the benchmark's initial weights
and the loss and Adam of its fit of the served weights. (The tests import both sides; the
reference itself imports nothing of the program.)"""

import numpy as np
import pytest
import torch

from atomai_tpu_torch.nets.fcnn import Unet as PortUnet
from atomai_tpu_torch.ops import cc_kernel
from atomai_tpu_torch.ops import roofline as port_roofline
from atomai_tpu_torch.predictors import Locator
from atomai_tpu_torch.utils import coords as port_coords
from atomai_tpu_torch.utils import imgen

import lattice
import roofline
from reference import compare, locate
from reference import unet as ref_unet
from weights import Adam, bce_with_logits, initial_state

MODEL = {"name": "Unet", "nb_classes": 1, "nb_filters": 16,
         "layers": [1, 2, 2, 3]}


def _nets(seed=0):
    port = PortUnet(1, 16, layers=(1, 2, 2, 3))
    ref = ref_unet.build(MODEL, "cpu")
    state = initial_state(MODEL, "cpu", seed)
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def test_state_dicts_carry_over_both_ways():
    port, ref = _nets()
    assert list(port.state_dict()) == list(ref.state_dict())
    ref.load_state_dict(port.state_dict())
    assert sum(p.numel() for p in ref.parameters()) == 594033


@pytest.mark.parametrize("train", [False, True])
def test_reference_unet_is_the_port_unet(train):
    port, ref = _nets(3)
    x = torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(1))
    port.train(train)
    ref.train(train)
    a, b = port(x), ref(x)
    assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)
    a.square().mean().backward()
    b.square().mean().backward()
    for (k, p), q in zip(port.named_parameters(), ref.parameters()):
        assert torch.allclose(p.grad, q.grad, atol=1e-6, rtol=1e-4), k


def test_initial_state_is_torch_default_init():
    state = initial_state(MODEL, "cpu", 7)
    w = state["c2.block.0.weight"]
    bound = 1 / np.sqrt(16 * 9)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert (state["c2.block.2.weight"] == 1).all()
    assert (state["c2.block.2.running_var"] == 1).all()
    assert torch.equal(state["px.bias"], initial_state(MODEL, "cpu", 7)[
        "px.bias"])
    assert not torch.equal(w, initial_state(MODEL, "cpu", 8)[
        "c2.block.0.weight"])


def test_frozen_generator_is_the_port_generator():
    a = lattice.make_lattice_stack(3, 128, 16, seed=2 ** 32 - 1)
    b = imgen.make_lattice_stack(3, 128, 16, seed=2 ** 32 - 1)
    for x, y in zip(a[:2], b[:2]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("shape", [(64 * 257, 256), (4 * 513, 512),
                                   (2048, 2048), (7, 9)])
@pytest.mark.parametrize("blobs", [0, 1, 13000])
def test_labeller_bytes_are_the_port_count(shape, blobs):
    assert roofline.cc_label_bytes(*shape, blobs) == \
        cc_kernel.cc_label_bytes(*shape, blobs)


def test_peaks_are_the_port_peaks():
    assert roofline.H100_BF16_FLOPS == port_roofline.H100_BF16_FLOPS
    assert roofline.H100_HBM_BYTES == port_roofline.H100_HBM_BYTES
    assert roofline.locator_bytes(64, 256, 256, 0) == \
        cc_kernel.cc_label_bytes(64 * 257, 256)


def test_forward_flops_of_a_256_frame():
    f = roofline.net_flops(ref_unet.build(MODEL, "cpu"), (1, 1, 256, 256),
                           False)
    assert f == pytest.approx(4.30e9, rel=1e-3)
    step = roofline.net_flops(ref_unet.build(MODEL, "cpu"),
                              (32, 1, 256, 256), True)
    assert 2.9 < step / (32 * f) < 3.0


def _maps(n=3, size=96, seed=0):
    _, masks, _ = lattice.make_lattice_stack(n, size, 16, seed=seed)
    rng = np.random.default_rng(seed)
    return (masks * rng.uniform(0.5, 1, masks.shape) +
            rng.uniform(0, 0.45, masks.shape)).astype(np.float32)[..., None]


def test_reference_locator_is_the_port_locator():
    maps = _maps()
    port = Locator(0.5, device="cpu").run(maps)
    ref = locate.locate(maps)
    assert compare.coord_gap(port, ref) < 1e-4
    assert sum(len(v) for v in ref.values()) > 40


def test_reference_clusters_are_the_port_clusters():
    atoms = locate.locate(_maps(1, 256, 5))[0]
    rng = np.random.default_rng(0)
    members = {m: atoms + np.c_[rng.normal(0, .3, (len(atoms), 2)),
                                np.zeros(len(atoms))]
               for m in range(4)}
    _, port_means, _ = port_coords.cluster_coord(members, 1.0, 3)
    ref = locate.cluster_means(list(members.values()), 1.0, 3)
    assert len(ref) > 20
    assert compare.matched_gap(port_means, ref) < 1e-9


def test_reference_dbscan_is_the_port_dbscan():
    from atomai_tpu_torch.native import dbscan_reference
    pts = np.random.default_rng(1).uniform(0, 20, (400, 2))
    assert np.array_equal(locate.dbscan(pts, 1.0, 3),
                          dbscan_reference(pts, 1.0, 3))


def test_reference_adam_is_torch_adam():
    g = torch.Generator().manual_seed(0)
    p1 = torch.randn(50, generator=g)
    p2 = p1.clone().requires_grad_()
    opt = torch.optim.Adam([p2], lr=1e-3, eps=1e-8)
    ours = Adam({"p": p1})
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        ours.step({"p": grad})
        p2.grad = grad.clone()
        opt.step()
    assert torch.allclose(p1, p2.detach(), atol=1e-7)


def test_reference_loss_is_the_port_loss():
    from atomai_tpu_torch.losses_metrics.losses import select_loss
    g = torch.Generator().manual_seed(2)
    z, y = torch.randn(2, 1, 8, 8, generator=g), (torch.rand(
        2, 8, 8, generator=g) > .5).float()
    port = select_loss("ce", 1)(z.permute(0, 2, 3, 1), y)
    assert torch.allclose(bce_with_logits(z, y), port)

