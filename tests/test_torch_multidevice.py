"""The port's production paths in a world of two CPU ranks on ``gloo``,
against the port in one process and against the JAX package on an
explicit 2-device mesh (`tests/trainers/test_multidevice.py`).

One module-scoped launch runs every path in both ranks (``_ranks``) and
returns what each rank ended with; the one-process runs and the JAX runs
happen in the test process. The shapes are the JAX test's: a Unet with
``nb_filters=4``, ``layers=[1, 1, 1, 1]`` on 16 x 32², batch 8, 5 cycles.

Stated tolerances, float32 on the CPU:
- world 2 against one process, the same weights and batch order: the
  first loss 1e-5 relative (the split step reduces in another order), the
  5-cycle trajectory 1e-3 relative, weights 1e-3 of each tensor's largest
  |value|, or 2 * lr * steps for a weight whose gradient is rounding noise
  (a conv bias before BatchNorm; Adam moves it by lr either way a step),
  IoU accuracies (of the gathered outputs) 2e-3, as
  `tests/test_torch_trainer.py`;
- the Segmentor against the JAX package's 2-device mesh from the same
  weights: the first loss 1e-4 relative, the rest 1e-2 (the bounds of the
  segmentation parity tests); without augmentation, whose draws the two
  packages make from different generators;
- the rVAE: ELBOs 1e-4 relative against one process; one split step's
  ELBO and gradients against the JAX package's on its 2-device mesh, with
  the same noise, 1e-5 of each tensor's scale (`tests/test_torch_vae.py`'s
  bound);
- ensembles: each member 1e-6 of one process's member (the same
  computation, member for member), the predictor's mean and variance
  1e-5 (the JAX test's);
- the independent-output DKL: losses 1e-5 relative, posterior mean and
  variance 1e-4;
- where no mesh splits the work (a batch of 7, 3 members, 3 outputs),
  each rank from weights of its own seed: every rank ends with rank 0's
  model bit for bit, and ``mesh=False`` leaves each rank its own.
The ranks import this module, so it imports JAX only inside its fixtures.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from atomai_tpu_torch.core import mesh as M
from atomai_tpu_torch.models import Segmentor, dklGPR, rVAE, vae_from_jax
from atomai_tpu_torch.parallel import launch
from atomai_tpu_torch.predictors import EnsemblePredictor
from atomai_tpu_torch.trainers import EnsembleTrainer
from atomai_tpu_torch.utils import make_lattice_stack

torch.set_num_threads(1)

WORLD = 2
SMALL = dict(nb_filters=4, layers=[1, 1, 1, 1], device="cpu")
CYCLES, BATCH = 5, 8
TOL_FIRST_LOSS_REL, TOL_LOSS_REL, TOL_W_SCALED = 1e-5, 1e-3, 1e-3
TOL_JAX_FIRST_REL, TOL_JAX_REL = 1e-4, 1e-2
TOL_ELBO_REL, TOL_STEP_SCALED = 1e-4, 1e-5
TOL_MEMBER, TOL_ENS_PREDICT = 1e-6, 1e-5
TOL_IOU = 2e-3       # one flipped pixel of a batch's 8,192 moves it ~5e-4
TOL_DKL_LOSS_REL, TOL_DKL_POST = 1e-5, 1e-4
REPLICA_BATCH = 7    # prime: no data mesh of the two ranks divides it
AUG = dict(rotation=True, zoom=True, gauss_noise=[10, 30],
           poisson_noise=[30, 45], salt_and_pepper=True, blur=True,
           contrast=True, background=True)
SEG_CASES = {"ce": {"loss": "ce"}, "dice": {"loss": "dice"},
             "ce_augmented": {"loss": "ce", **AUG},
             "ce_full_epoch_swa_iou": {"loss": "ce", "full_epoch": True,
                                       "swa": True,
                                       "compute_accuracy": True},
             "ce_remat": {"loss": "ce", "remat": True}}
VAE_KW = dict(latent_dim=2, seed=4, numlayers_encoder=1,
              numhidden_encoder=32, numlayers_decoder=1,
              numhidden_decoder=32)


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


def _seg_data():
    rng = np.random.RandomState(1)
    X = rng.rand(16, 32, 32).astype(np.float32)
    y = (rng.rand(16, 32, 32) > 0.5).astype(np.float32)
    return X, y


def _seg_fit(variables, case, tmp, mesh=None):
    X, y = _seg_data()
    m = Segmentor("Unet", 1, seed=7, **SMALL)
    m.load_jax_variables(*variables)
    with _quiet():
        m.fit(X, y, X.copy(), y.copy(), training_cycles=CYCLES,
              batch_size=BATCH, print_loss=CYCLES,
              filename=os.path.join(tmp, case), mesh=mesh,
              **SEG_CASES[case])
    return m


def _vae_data():
    return np.random.RandomState(0).rand(64, 16, 16).astype(np.float32)


def _rvae_fit(tmp, mesh=None):
    m = rVAE((16, 16), device="cpu", **VAE_KW)
    m.fit(_vae_data(), training_cycles=3, batch_size=16, mesh=mesh,
          filename=os.path.join(tmp, "rvae"), verbose=False)
    return m


def _vae_step_inputs():
    rng = np.random.RandomState(2)
    return (rng.rand(8, 16, 16).astype(np.float32),
            rng.randn(8, 5).astype(np.float32))


def _rvae_step(params, mesh):
    """One split step's ELBO and averaged gradients at ``params`` with the
    given noise (each rank its rows of it)."""
    m = rVAE((16, 16), device="cpu", **VAE_KW)
    m.load_jax_params(params)
    m.dx_prior = 0.1
    m.kdict_["phi_prior"] = 0.1
    x, eps = (torch.from_numpy(a) for a in _vae_step_inputs())
    x, eps = M.shard_batch(mesh, x, eps)
    with M.split_batch(mesh):
        elbo = m.forward_compute_elbo(x, None, 100, eps=eps)
        elbo.backward()
    M.mean_gradients(m.parameters(), mesh)
    return float(elbo), (
        {k: p.grad.clone() for k, p in m.encoder_net.named_parameters()},
        {k: p.grad.clone() for k, p in m.decoder_net.named_parameters()})


def _lattice():
    imgs, masks, _ = make_lattice_stack(8, 32, 10, seed=1)
    return imgs, masks


def _ensembles(tmp, mesh=None):
    """From scratch (4 members) and from a baseline (2 members); the
    predictor of the first."""
    imgs, masks = _lattice()
    out = {}
    with _quiet():
        et = EnsembleTrainer("Unet", nb_classes=1, seed=3, **SMALL)
        et.compile_ensemble_trainer(training_cycles=4, batch_size=4,
                                    filename=os.path.join(tmp, "e1"),
                                    mesh=mesh)
        net, ens = et.train_ensemble_from_scratch(imgs, masks, n_models=4)
        out["scratch"] = (ens, list(et.loss_acc["train_loss"]),
                          M.axis_size(et._resolve_mesh(4), M.MODEL_AXIS))
        p = EnsemblePredictor(net, ens, nb_classes=1, verbose=0, mesh=mesh)
        out["predict"] = p.predict(imgs, num_batches=1) + (
            M.axis_size(p._mesh, M.MODEL_AXIS), len(p.members))
        et = EnsembleTrainer("Unet", nb_classes=1, seed=3, **SMALL)
        et.compile_ensemble_trainer(training_cycles=4, batch_size=4,
                                    filename=os.path.join(tmp, "e2"),
                                    mesh=mesh)
        net, ens = et.train_ensemble_from_baseline(
            imgs, masks, n_models=2, training_cycles_base=4,
            training_cycles_ensemble=2)
        out["baseline"] = (ens, list(et.loss_acc["train_loss"]),
                           net.state_dict(), M.axis_size(et.mesh,
                                                         M.DATA_AXIS))
    return out


def _dkl_data():
    rng = np.random.RandomState(0)
    return (rng.randn(64, 16).astype(np.float32),
            rng.randn(4, 64).astype(np.float32))


def _dkl_fit(mesh=None):
    X, y = _dkl_data()
    m = dklGPR(16, embedim=2, shared_embedding_space=False, seed=2,
               device="cpu")
    with _quiet():
        m.fit(X, y, training_cycles=5, mesh=mesh, print_loss=10)
    mean, var = m.predict(X[:8])
    return {"loss": list(m.train_loss), "mean": mean, "var": var,
            "mesh": None if m.model_mesh is None else tuple(
                m.model_mesh.shape)}


def _replicas(rank, tmp):
    """Fits that no mesh splits at world 2 (a batch of 7, 3 members, 3
    outputs), each rank from weights of its own seed, on the automatic
    mesh and with ``mesh=False``: the meshes found and what each rank
    ends with."""
    X, y = _seg_data()
    imgs, masks = _lattice()
    Xd, yd = _dkl_data()
    out = {}
    for name, mesh in (("auto", None), ("off", False)):
        with _quiet():
            m = Segmentor("Unet", 1, seed=7 + rank, **SMALL)
            m.fit(X[:14], y[:14], training_cycles=2,
                  batch_size=REPLICA_BATCH, print_loss=2, mesh=mesh,
                  filename=os.path.join(tmp, f"rep_seg_{name}"))
            v = rVAE((16, 16), device="cpu", **{**VAE_KW, "seed": rank})
            v.fit(_vae_data()[:14], training_cycles=1,
                  batch_size=REPLICA_BATCH, mesh=mesh, verbose=False,
                  filename=os.path.join(tmp, f"rep_rvae_{name}"))
            et = EnsembleTrainer("Unet", nb_classes=1, seed=3 + rank,
                                 **SMALL)
            et.compile_ensemble_trainer(
                training_cycles=2, batch_size=4, mesh=mesh,
                filename=os.path.join(tmp, f"rep_ens_{name}"))
            _, ens = et.train_ensemble_from_scratch(imgs, masks, n_models=3)
            gp = dklGPR(16, embedim=2, shared_embedding_space=False,
                        seed=2 + rank, device="cpu")
            gp.fit(Xd, yd[:3], training_cycles=2, mesh=mesh, print_loss=10)
        out[name] = {
            "meshes": [m.mesh, v.mesh, et._resolve_mesh(3), gp.model_mesh],
            "seg": (m.net.state_dict(), m.loss_acc["train_loss"]),
            "rvae": (v._state(), v.loss_history["train_loss"]),
            "ens": (ens, et.loss_acc["train_loss"]),
            "dkl": (gp.predict(Xd[:8]), gp.train_loss)}
    return out


def _ranks(rank, variables, vae_params, tmp):
    """Every path, in each rank of the world of 2 (automatic meshes)."""
    tmp = os.path.join(tmp, f"rank{rank}")
    os.makedirs(tmp)
    out = {"replicas": _replicas(rank, tmp)}
    for case in SEG_CASES:
        m = _seg_fit(variables, case, tmp)
        out[case] = {"mesh": tuple(m.mesh.shape), "loss": m.loss_acc,
                     "state": m.net.state_dict()}
    m = _rvae_fit(tmp)
    out["rvae"] = {"mesh": tuple(m.mesh.shape),
                   "loss": m.loss_history["train_loss"],
                   "state": m._state()}
    out["rvae_step"] = _rvae_step(vae_params, M.get_mesh())
    out["ensembles"] = _ensembles(tmp)
    out["dkl"] = _dkl_fit()
    return out


def _jax_unet_variables():
    import jax
    import jax.numpy as jnp
    from atomai_tpu.models import Segmentor as JaxSegmentor
    X, _ = _seg_data()
    jm = JaxSegmentor("Unet", 1, seed=7, **SMALL)
    v = jax.device_get(jm.net.init(
        {"params": jax.random.key(3), "dropout": jax.random.key(3)},
        jnp.asarray(X[:1, ..., None]), False))
    return (jax.tree.map(np.asarray, dict(v["params"])),
            jax.tree.map(np.asarray, dict(v["batch_stats"])))


def _jax_vae_params():
    import jax
    import atomai_tpu as jaoi
    jm = jaoi.models.rVAE((16, 16), **{k: v for k, v in VAE_KW.items()})
    jm._init_params()
    return jax.tree.map(np.asarray, jax.device_get(jm.params))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multidevice"))
    variables, vae_params = _jax_unet_variables(), _jax_vae_params()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AOI_AUTO_MESH", "1")     # the suite's default is off
        ranks = launch(_ranks, WORLD, "cpu",
                       args=(variables, vae_params, tmp), deadline=600)
    return {"ranks": ranks, "variables": variables,
            "vae_params": vae_params, "tmp": tmp}


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from atomai_tpu.core.mesh import get_mesh
    return get_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])


def _close_weights(got, want, steps, lr=1e-3, params=()):
    for k, w in want.items():
        if not w.is_floating_point() or k.endswith("num_batches_tracked"):
            continue
        err = float((got[k] - w).abs().max())
        bound = TOL_W_SCALED * float(w.abs().max())
        assert err <= max(bound, 2 * lr * steps if k in params else 0), \
            (k, err, bound)


def _close_losses(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    assert abs(got[0] / want[0] - 1) <= TOL_FIRST_LOSS_REL, (got, want)
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS_REL)


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmentor_data_parallel_matches_one_process(setup, case, tmp_path):
    one = _seg_fit(setup["variables"], case, str(tmp_path), mesh=False)
    assert one.mesh is None
    r0 = setup["ranks"][0][case]
    assert r0["mesh"] == (2, 1)
    for k in ("train_loss", "test_loss"):
        _close_losses(r0["loss"][k], one.loss_acc[k])
    for k in ("train_accuracy", "test_accuracy"):    # the gathered IoU
        np.testing.assert_allclose(r0["loss"][k], one.loss_acc[k],
                                   atol=TOL_IOU)
    steps = CYCLES * (2 if SEG_CASES[case].get("full_epoch") else 1)
    _close_weights(r0["state"], one.net.state_dict(), steps,
                   params=dict(one.net.named_parameters()))


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmentor_ranks_hold_the_same_model(setup, case):
    r0, r1 = (r[case] for r in setup["ranks"])
    assert r0["loss"] == r1["loss"]
    for k, v in r0["state"].items():
        assert torch.equal(r1["state"][k], v), k


@pytest.mark.parametrize("case", ["ce", "dice"])
def test_segmentor_data_parallel_matches_jax_mesh(setup, jax_mesh, case,
                                                  tmp_path):
    from atomai_tpu.models import Segmentor as JaxSegmentor
    X, y = _seg_data()
    jm = JaxSegmentor("Unet", 1, seed=7, **SMALL)
    jm.params, jm.batch_stats = setup["variables"]
    with _quiet():
        jm.fit(X, y, X.copy(), y.copy(), training_cycles=CYCLES,
               batch_size=BATCH, print_loss=CYCLES, mesh=jax_mesh,
               filename=str(tmp_path / "jax"), **SEG_CASES[case])
    assert jm.mesh is jax_mesh
    got = setup["ranks"][0][case]["loss"]
    for k in ("train_loss", "test_loss"):
        g, w = np.asarray(got[k]), np.asarray(jm.loss_acc[k])
        assert abs(g[0] / w[0] - 1) <= TOL_JAX_FIRST_REL, (k, g, w)
        np.testing.assert_allclose(g, w, rtol=TOL_JAX_REL, err_msg=k)


def test_rvae_data_parallel_matches_one_process(setup, tmp_path):
    one = _rvae_fit(str(tmp_path), mesh=False)
    assert one.mesh is None
    r0, r1 = (r["rvae"] for r in setup["ranks"])
    assert r0["mesh"] == (2, 1)
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one.loss_history["train_loss"],
                               rtol=TOL_ELBO_REL)
    for part, want in one._state().items():
        _close_weights(r0["state"][part], want, 3 * 4, lr=1e-4,
                       params=want)
        for k, v in r0["state"][part].items():
            assert torch.equal(r1["state"][part][k], v), k


def test_rvae_split_step_matches_jax_mesh(setup, jax_mesh):
    """The ELBO and gradients of one batch split over the two ranks, with
    the same noise, against the JAX package's on its 2-device mesh (the
    batch and the noise sharded over the data axis)."""
    import jax
    import jax.numpy as jnp
    import atomai_tpu as jaoi
    from atomai_tpu.core.mesh import shard_batch
    params = setup["vae_params"]
    jm = jaoi.models.rVAE((16, 16), **VAE_KW)
    jm._init_params()
    jm.dx_prior = 0.1
    jm.kdict_["phi_prior"] = 0.1
    x, eps = _vae_step_inputs()
    xs, es = shard_batch(jax_mesh, jnp.asarray(x), jnp.asarray(eps))
    assert len(xs.sharding.device_set) == 2
    jm.reparameterize = lambda key, mu, sd: mu + sd * es
    with jax.default_matmul_precision("highest"):
        elbo, grads = jax.value_and_grad(
            lambda p: jm.forward_compute_elbo_fn(
                p, xs, None, jax.random.key(0), 100, True))(params)
    grads = vae_from_jax(jax.tree.map(np.asarray, grads),
                         rVAE((16, 16), device="cpu", **VAE_KW).metadict)
    for r in setup["ranks"]:
        got_elbo, got = r["rvae_step"]
        np.testing.assert_allclose(got_elbo, float(elbo), rtol=TOL_STEP_SCALED)
        for part, g, w in zip(("encoder", "decoder"), got, grads):
            assert set(g) == set(w), part
            for k in w:
                scale = max(float(w[k].abs().max()), 1e-6)
                np.testing.assert_allclose(g[k] / scale, w[k] / scale,
                                           atol=TOL_STEP_SCALED, rtol=0,
                                           err_msg=f"{part}.{k}")


@pytest.fixture(scope="module")
def one_ensembles(tmp_path_factory):
    return _ensembles(str(tmp_path_factory.mktemp("ens")), mesh=False)


def test_ensemble_members_over_the_model_axis(setup, one_ensembles):
    """From scratch: every rank returns every member, member i equal to
    the one-process member i, and the members' mean loss of each
    cycle."""
    want, want_loss = one_ensembles["scratch"][:2]
    for r in setup["ranks"]:
        got, loss, n_axis = r["ensembles"]["scratch"]
        assert n_axis == 2 and sorted(got) == sorted(want)
        for i in want:
            for k, w in want[i].items():
                np.testing.assert_allclose(got[i][k], w, atol=TOL_MEMBER,
                                           rtol=0, err_msg=f"{i}.{k}")
        np.testing.assert_allclose(loss, want_loss, rtol=TOL_MEMBER)


def test_ensemble_from_baseline_splits_the_baseline_fit(setup,
                                                        one_ensembles):
    """From a baseline: the baseline fit splits its batches over the
    automatic data mesh (4 cycles), then 2 members fine-tune over the model
    axis (2 cycles); held to one process with the data-parallel bounds."""
    want, want_loss, want_net, n_data = one_ensembles["baseline"]
    assert n_data == 1
    for r in setup["ranks"]:
        got, loss, net, n_data = r["ensembles"]["baseline"]
        assert n_data == 2 and sorted(got) == sorted(want)
        for i in want:
            _close_weights(got[i], want[i], 6, params=want_net)
        _close_weights(net, want_net, 6, params=want_net)
        _close_losses(loss, want_loss)


def test_ensemble_predictor_over_the_model_axis(setup, one_ensembles):
    mean1, var1, n_axis, n_local = one_ensembles["predict"]
    assert (n_axis, n_local) == (1, 4)
    for r in setup["ranks"]:
        mean, var, n_axis, n_local = r["ensembles"]["predict"]
        assert (n_axis, n_local) == (2, 2)
        np.testing.assert_allclose(mean, mean1, atol=TOL_ENS_PREDICT)
        np.testing.assert_allclose(var, var1, atol=TOL_ENS_PREDICT)


def test_independent_dkl_outputs_over_the_model_axis(setup):
    one = _dkl_fit(mesh=False)
    assert one["mesh"] is None
    for r in setup["ranks"]:
        got = r["dkl"]
        assert got["mesh"] == (1, 2)
        np.testing.assert_allclose(got["loss"], one["loss"],
                                   rtol=TOL_DKL_LOSS_REL)
        np.testing.assert_allclose(got["mean"], one["mean"],
                                   atol=TOL_DKL_POST)
        np.testing.assert_allclose(got["var"], one["var"],
                                   atol=TOL_DKL_POST)


def _leaves(tree):
    """The arrays of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [np.asarray(tree)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("path", ["seg", "rvae", "ens", "dkl"])
def test_replicas_end_with_rank0s_model(setup, path):
    """Where no mesh splits the work (a batch of 7, 3 members, 3 outputs
    at world 2), every rank trains a replica; rank 1 starts from weights
    of its own seed here, so only the closing sync from rank 0 can make
    the ranks equal. The automatic fit ends every rank with rank 0's
    model and history, rank 0's being its one-process fit; an explicit
    ``mesh=False`` leaves each rank its own."""
    r0, r1 = (r["replicas"] for r in setup["ranks"])
    assert r0["auto"]["meshes"] == r1["auto"]["meshes"] == [None] * 4
    assert _same(r0["auto"][path], r1["auto"][path])
    assert _same(r0["auto"][path], r0["off"][path])
    assert not _same(r0["off"][path], r1["off"][path])
