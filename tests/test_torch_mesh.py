"""The port's device-mesh layer (``core.mesh``, ``parallel``) in a world of
four CPU ranks on ``gloo``, against one process.

One module-scoped launch runs every check of the module in the ranks
(``_ranks``) and returns their results; the tests then hold them:
- mesh resolution, as `tests/trainers/test_mesh_resolution.py:23-61` holds
  the JAX package's at 8 devices: the ``AOI_AUTO_MESH`` opt-out, the
  batch-divisor sizing, explicit choices, the spread of members;
- the global BatchNorm at world sizes 2 and 4 against ``nn.BatchNorm2d`` on
  the concatenated batch: outputs within 1e-6, input and weight gradients
  within 1e-5, running statistics within 1e-6;
- a generator-driven Dropout in a split step: the global batch's mask,
  sliced, bit for bit;
- the sharded ``SegPredictor`` on 10 frames (padded to 12) at world sizes
  2 and 4: maps within 1e-5 of one process (the JAX package's
  `tests/trainers/test_multidevice.py:239-262`);
- ranks outside an automatic data mesh (batch 6 at world 4: a mesh of 3):
  every rank ends with the same weights and history, within the
  one-process bounds of `tests/test_torch_multidevice.py`.
``parallel.dryrun.dryrun_multichip(2, device="cpu")`` runs in a launch of
its own, and so does each case of a hung rank (the launch's deadline, the
process group's timeout). Each rank keeps to one thread; the ranks import this module, so
it imports nothing of JAX.
"""

import contextlib
import io
import os
import time

import numpy as np
import pytest
import torch
import torch.nn as nn

from atomai_tpu_torch.core import mesh as M
from atomai_tpu_torch.models import Segmentor
from atomai_tpu_torch.nets import Dropout
from atomai_tpu_torch.parallel import launch
from atomai_tpu_torch.parallel.sync_bn import global_batch_norm
from atomai_tpu_torch.predictors import SegPredictor

torch.set_num_threads(1)

WORLD = 4
TOL_BN_OUT, TOL_BN_GRAD, TOL_BN_STATS = 1e-6, 1e-5, 1e-6
TOL_MAPS = 1e-5
# one process against the split fit (3 Adam(1e-3) cycles): a weight whose
# gradient is rounding noise (a conv bias before BatchNorm) moves by lr
# either way a step, so 2 * lr * cycles bounds it besides 1e-3 of scale
TOL_FIRST_LOSS_REL, TOL_LOSS_REL, TOL_W_SCALED = 1e-5, 1e-3, 1e-3
CYCLES = 3
TOL_ADAM = 2 * 1e-3 * CYCLES
SMALL = dict(nb_filters=4, layers=[1, 1, 1, 1], device="cpu")


def _bn_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 3, 5, 5).astype(np.float32) * 2 + 1,
            rng.randn(8, 3, 5, 5).astype(np.float32),
            rng.rand(3).astype(np.float32) + 0.5,
            rng.randn(3).astype(np.float32))


def _bn(weight, bias):
    bn = nn.BatchNorm2d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn


def _bn_step(mesh):
    """The trainers' step on a BatchNorm: this rank's rows, the global mean
    of (y * probe) as the loss, gradients averaged. Returns (the output's
    rows, the input's gradient over the data size: each rank's is the data
    size times its part, as ``core.mesh`` says, the weight's and bias's
    gradients, the running statistics)."""
    x, probe, weight, bias = _bn_inputs()
    bn = _bn(weight, bias).train()
    xr, pr = M.shard_batch(mesh, torch.from_numpy(x), torch.from_numpy(probe))
    xr = xr.clone().requires_grad_()
    with M.split_batch(mesh), global_batch_norm(bn):
        y = bn(xr)
        loss = M.split_mean((y * pr).mean())
        loss.backward()
    M.mean_gradients(bn.parameters(), mesh)
    k = M.axis_size(mesh, M.DATA_AXIS)
    return {"y": y.detach(), "gx": xr.grad / k, "gw": bn.weight.grad,
            "gb": bn.bias.grad, "rm": bn.running_mean.clone(),
            "rv": bn.running_var.clone(), "loss": float(loss)}


def _dropout_rows(mesh):
    x = torch.ones(8, 3, 4, 4)
    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(5)
    with M.split_batch(mesh):
        return d(M.shard_batch(mesh, x))


def _frames():
    return np.random.RandomState(0).rand(10, 32, 32).astype(np.float32)


def _seg_data():
    rng = np.random.RandomState(1)
    X = rng.rand(12, 32, 32).astype(np.float32)
    y = (rng.rand(12, 32, 32) > 0.5).astype(np.float32)
    return X, y


def _seg_fit(tmp, mesh=None):
    X, y = _seg_data()
    m = Segmentor("Unet", 1, seed=3, **SMALL)
    with contextlib.redirect_stdout(io.StringIO()):
        m.fit(X, y, X, y, training_cycles=CYCLES, batch_size=6,
              print_loss=CYCLES,
              filename=os.path.join(tmp, "seg"), mesh=mesh)
    return m


def _shape(m):
    return None if m is None else tuple(m.shape)


def _ranks(rank, tmp):
    """Every check of the module, in each rank of the world of 4."""
    out = {}
    # resolution (the JAX package's test_mesh_resolution, at 4 devices)
    os.environ["AOI_AUTO_MESH"] = "0"
    m2 = M.get_mesh(n_data=2, n_model=1)
    out["optout"] = (M.resolve_data_mesh(None, 32),
                     M.resolve_model_mesh(None, 4),
                     M.resolve_data_mesh(m2, 32) is m2,
                     M.resolve_model_mesh(m2, 4) is m2,
                     M.resolve_data_mesh(False, 32))
    os.environ["AOI_AUTO_MESH"] = "1"
    out["sizes"] = {bs: _shape(M.resolve_data_mesh(None, bs))
                    for bs in (32, 8, 12, 6, 4, 3, 2, 1, 7, None)}
    out["explicit"] = (M.resolve_data_mesh(False, 32) is None,
                       M.resolve_data_mesh(m2, 5) is m2,
                       M.resolve_model_mesh(False, 8) is None,
                       M.resolve_model_mesh(m2, 8) is m2)
    out["members"] = {n: _shape(M.resolve_model_mesh(None, n))
                      for n in (8, 4, 3, 2, 1)}
    out["ensemble_mesh_2"] = _shape(M.ensemble_mesh(2))
    e = M.ensemble_mesh(2)
    out["blocks"] = (M.block(8, e, M.MODEL_AXIS), M.block(8, e, M.DATA_AXIS),
                     M.axis_index(e, M.DATA_AXIS),
                     M.axis_index(e, M.MODEL_AXIS),
                     [M.block_owner(e, M.MODEL_AXIS, j) for j in range(2)])
    out["shard_member_stacked"] = M.shard_member_stacked(
        {"w": torch.arange(6.), "s": torch.tensor(1.)}, e)
    out["shard_batch"] = M.shard_batch(M.get_mesh(), torch.arange(8),
                                       torch.arange(6))
    # the global BatchNorm and Dropout at world sizes 2 and 4
    full = M.get_mesh()
    for k, mesh in ((2, m2), (4, full)):
        if M.in_mesh(mesh):
            out[f"bn{k}"] = _bn_step(mesh)
            out[f"dropout{k}"] = _dropout_rows(mesh)
    # the sharded SegPredictor, 10 frames
    net = Segmentor("Unet", 1, seed=0, **SMALL).net
    for k, mesh in ((2, m2), (4, None)):
        p = SegPredictor(net, nb_classes=1, verbose=False, mesh=mesh)
        out[f"predictor_mesh{k}"] = _shape(p.mesh)
        out[f"maps{k}"] = p.predict(_frames(), num_batches=1)
    # ranks outside an automatic mesh: batch 6 at world 4 (a mesh of 3)
    m = _seg_fit(tmp)
    out["outside"] = {"mesh": _shape(m.mesh), "loss": m.loss_acc,
                      "state": m.net.state_dict()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    return launch(_ranks, WORLD, "cpu", args=(tmp,), deadline=300)


def test_no_mesh_without_a_process_group():
    """One process: no automatic mesh; False is none; anything but a
    DeviceMesh raises; a mesh needs a process group."""
    assert M.resolve_data_mesh(None, 8) is None
    assert M.resolve_model_mesh(None, 4) is None
    assert M.resolve_data_mesh(False) is None
    with pytest.raises(TypeError, match="DeviceMesh"):
        M.resolve_data_mesh(object())
    with pytest.raises(RuntimeError, match="process group"):
        M.get_mesh(n_data=2)
    assert M.shard_batch(None, torch.arange(4)).tolist() == [0, 1, 2, 3]
    assert M.block(6, None, M.MODEL_AXIS) == slice(0, 6)


def test_auto_mesh_env_optout(ranks):
    for r in ranks:
        d, m, given_d, given_m, off = r["optout"]
        assert d is None and m is None and off is None
        assert given_d and given_m


def test_auto_data_mesh_sizes_to_batch_divisor(ranks):
    want = {32: (4, 1), 8: (4, 1), 12: (4, 1), 6: (3, 1), 4: (4, 1),
            3: (3, 1), 2: (2, 1), 1: None, 7: None, None: (4, 1)}
    for r in ranks:
        assert r["sizes"] == want


def test_explicit_mesh_choices_respected(ranks):
    for r in ranks:
        assert all(r["explicit"])


def test_model_mesh_spreads_members(ranks):
    for r in ranks:
        assert r["members"] == {8: (1, 4), 4: (1, 4), 3: (1, 3),
                                2: (2, 2), 1: None}
        assert r["ensemble_mesh_2"] == (2, 2)


def test_blocks_and_shards_are_contiguous(ranks):
    for rank, r in enumerate(ranks):
        model_block, data_block, di, mi, owners = r["blocks"]
        assert (di, mi) == (rank // 2, rank % 2)
        assert model_block == slice(4 * mi, 4 * mi + 4)
        assert data_block == slice(4 * di, 4 * di + 4)
        assert owners == [0, 1]
        got = r["shard_member_stacked"]
        assert got["w"].tolist() == [3. * mi, 3. * mi + 1, 3. * mi + 2]
        assert float(got["s"]) == 1.
        rows, whole = r["shard_batch"]
        assert rows.tolist() == [2 * rank, 2 * rank + 1]
        assert whole.tolist() == list(range(6))   # 6 rows: not split


@pytest.mark.parametrize("world", [2, 4])
def test_global_batch_norm_matches_concatenated_batch(ranks, world):
    x, probe, weight, bias = _bn_inputs()
    bn = _bn(weight, bias).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(probe)).mean().backward()
    got = [r[f"bn{world}"] for r in ranks[:world]]
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]),
                               y.detach(), atol=TOL_BN_OUT, rtol=0)
    np.testing.assert_allclose(torch.cat([g["gx"] for g in got]),
                               xt.grad, atol=TOL_BN_GRAD, rtol=0)
    for g in got:
        np.testing.assert_allclose(g["gw"], bn.weight.grad, atol=TOL_BN_GRAD,
                                   rtol=0)
        np.testing.assert_allclose(g["gb"], bn.bias.grad, atol=TOL_BN_GRAD,
                                   rtol=0)
        np.testing.assert_allclose(g["rm"], bn.running_mean,
                                   atol=TOL_BN_STATS, rtol=0)
        np.testing.assert_allclose(g["rv"], bn.running_var,
                                   atol=TOL_BN_STATS, rtol=0)
    assert "bn2" not in ranks[2] and "bn2" not in ranks[3]


@pytest.mark.parametrize("world", [2, 4])
def test_dropout_masks_are_the_global_batch_s(ranks, world):
    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(5)
    want = d(torch.ones(8, 3, 4, 4))
    got = torch.cat([r[f"dropout{world}"] for r in ranks[:world]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_seg_predictor_matches_one_process(ranks, world):
    """10 frames, padded to a multiple of the data axis; every rank gets
    the whole maps (ranks outside the 2-rank mesh compute them alone)."""
    net = Segmentor("Unet", 1, seed=0, **SMALL).net
    p = SegPredictor(net, nb_classes=1, verbose=False, mesh=False)
    assert p.mesh is None
    want = p.predict(_frames(), num_batches=1)
    for r in ranks:
        assert r[f"predictor_mesh{world}"] == (world, 1)
        assert r[f"maps{world}"].shape == want.shape == (10, 32, 32, 1)
        np.testing.assert_allclose(r[f"maps{world}"], want, atol=TOL_MAPS,
                                   rtol=0)


def test_ranks_outside_an_auto_mesh_end_equal(ranks, tmp_path):
    """Batch 6 at world 4: ranks 0-2 split each batch, rank 3 computes a
    replica, and all four end with rank 0's weights and history."""
    one = _seg_fit(str(tmp_path))
    r0 = ranks[0]["outside"]
    assert r0["mesh"] == (3, 1)
    for r in ranks[1:]:
        assert r["outside"]["loss"] == r0["loss"]
        for k, v in r0["state"].items():
            assert torch.equal(r["outside"]["state"][k], v), k
    tr = np.asarray(r0["loss"]["train_loss"])
    want = np.asarray(one.loss_acc["train_loss"])
    assert abs(tr[0] / want[0] - 1) <= TOL_FIRST_LOSS_REL
    np.testing.assert_allclose(tr, want, rtol=TOL_LOSS_REL)
    params = dict(one.net.named_parameters())
    for k, w in one.net.state_dict().items():
        if w.is_floating_point():
            err = float((r0["state"][k] - w).abs().max())
            bound = TOL_W_SCALED * float(w.abs().max())
            assert err <= max(bound, TOL_ADAM if k in params else 0), k


def test_dryrun_multichip_runs_all_four_paths(capsys, monkeypatch):
    """The four paths at world 2 (every rank the same losses), held to one
    process's numbers at the same shapes: the split fits with the bounds
    above, the member and output axes (the same computations) at 1e-6."""
    from atomai_tpu_torch.parallel.dryrun import dryrun_multichip, paths
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # a thread a rank
    res = dryrun_multichip(2, device="cpu", deadline=300)
    assert res["seg_mesh"] == res["rvae_mesh"] == (2, 1)
    assert res["ens_mesh"] == res["dkl_mesh"] == (1, 2)
    assert "dryrun_multichip OK" in capsys.readouterr().out
    one = paths(2, "cpu", mesh=False)
    assert one["seg_mesh"] is one["ens_mesh"] is one["dkl_mesh"] is None
    for k, rtol in (("seg_loss", TOL_LOSS_REL), ("rvae_loss", 1e-4),
                    ("ens_loss", 1e-6), ("dkl_loss", 1e-6)):
        assert abs(res[k][0] / one[k][0] - 1) <= TOL_FIRST_LOSS_REL, k
        np.testing.assert_allclose(res[k], one[k], rtol=rtol, err_msg=k)


def _hang(rank):
    """Rank 1 hangs; rank 0 returns and waits for it in the launch's
    closing barrier."""
    if rank == 1:
        time.sleep(600)
    return rank


@pytest.mark.parametrize("limit", ["deadline", "timeout"])
def test_launch_fails_a_hung_rank(limit):
    """A hung rank fails the launch instead of hanging it: at the
    launch's ``deadline``, or, without one, when the process group's
    ``timeout`` ends rank 0's wait in a collective (a deadline of 120 s
    stands behind that case, so that a fault fails it, not hangs it)."""
    from torch.multiprocessing import ProcessRaisedException
    t0 = time.monotonic()
    if limit == "deadline":
        with pytest.raises(TimeoutError, match="within 5 s"):
            launch(_hang, 2, "cpu", deadline=5)
    else:
        with pytest.raises(ProcessRaisedException):
            launch(_hang, 2, "cpu", timeout=5, deadline=120)
    assert time.monotonic() - t0 < 60
