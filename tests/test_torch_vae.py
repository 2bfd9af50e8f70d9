"""The port's VAE family (rVAE, VAE) against the JAX package's.

With the JAX params carried over by ``vae_from_jax``, the same numpy batch
and the same numpy noise (the JAX side gets it by replacing its
``reparameterize`` on the instance), both packages give the same ELBO and
the same gradient of every parameter, in float32 on the CPU: 1e-5
relative (gradients after dividing by each tensor's scale). One Adam step
gives the same parameters. The coordinate grid, its transform and the
losses agree with the JAX functions. A short ``rVAE.fit`` trains, saves,
reloads, and runs ``decode``, ``reconstruct`` and ``manifold2d``; the
card's fixture (one config C step made by JAX) is current, and the port
reproduces it.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import atomai_tpu as jaoi
from atomai_tpu.losses_metrics import vi_losses as jl
from atomai_tpu.utils import coords as jcoords
import atomai_tpu_torch as aoi
from atomai_tpu_torch.core import checkpoint
from atomai_tpu_torch.losses_metrics import vi_losses as tl
from atomai_tpu_torch.models import vae_from_jax
from atomai_tpu_torch.nets import fcEncoderNet, init_VAE_nets, init_weights_
from atomai_tpu_torch.core.prng import generator_from_seed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# config C's weight gradients sum 131,072 pixel rows: the two packages'
# float32 summation orders differ by up to ~1.5e-5 of a tensor's scale
FIXTURE_TOL = 3e-5
LR = 1e-4

# (class name, constructor kwargs, in_dim, labels): small widths
CONFIGS = {
    "rvae": ("rVAE", dict(numhidden_encoder=32, numhidden_decoder=32),
             (12, 12), False),
    "rvae_no_translation": ("rVAE", dict(translation=False,
                                         numhidden_decoder=48,
                                         numlayers_decoder=3), (10, 10),
                            False),
    "rvae_classes": ("rVAE", dict(nb_classes=2, numhidden_decoder=16),
                     (8, 8), True),
    "rvae_skip": ("rVAE", dict(skip=True, numhidden_decoder=16), (8, 8),
                  False),
    "vae": ("VAE", dict(numhidden_encoder=24, numhidden_decoder=24),
            (10, 10), False),
    "vae_conv_capacity": ("VAE", dict(conv_encoder=True,
                                      numhidden_encoder=4,
                                      numlayers_encoder=1,
                                      capacity=[5.0, 1000, 30]), (8, 8),
                          False),
}


def _models(name, seed=0):
    cls, kwargs, in_dim, labels = CONFIGS[name]
    jm = getattr(jaoi.models, cls)(in_dim, seed=seed, **kwargs)
    jm._init_params()
    tm = getattr(aoi.models, cls)(in_dim, seed=seed, device="cpu", **kwargs)
    params = jax.tree.map(np.asarray, jax.device_get(jm.params))
    tm.load_jax_params(params)
    if cls == "rVAE":
        for m in (jm, tm):
            m.dx_prior = 0.1
            m.kdict_["phi_prior"] = 0.1
    return jm, tm, params, labels


def _batch(jm, labels, b=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, *jm.in_dim).astype(np.float32)
    eps = rng.randn(b, jm.z_dim).astype(np.float32)
    y = rng.randint(0, 2, b) if labels else None
    return x, eps, y


def _jax_elbo_and_grads(jm, params, x, eps, y, num_iter):
    jm.reparameterize = lambda key, mu, sd: mu + sd * jnp.asarray(eps)

    def elbo_fn(p):
        return jm.forward_compute_elbo_fn(
            p, jnp.asarray(x), None if y is None else jnp.asarray(y),
            jax.random.key(0), num_iter, True)

    with jax.default_matmul_precision("highest"):
        elbo, grads = jax.value_and_grad(elbo_fn)(params)
    return float(elbo), jax.tree.map(np.asarray, grads)


def _port_elbo(tm, x, eps, y, num_iter):
    return tm.forward_compute_elbo(
        torch.from_numpy(x), None if y is None else torch.from_numpy(y),
        num_iter, eps=torch.from_numpy(eps))


def _named_grads(tm):
    return ({k: p.grad for k, p in tm.encoder_net.named_parameters()},
            {k: p.grad for k, p in tm.decoder_net.named_parameters()})


def _assert_trees(port, ref, tol, what):
    for part, got, want in zip(("encoder", "decoder"), port, ref):
        assert set(got) == set(want), (what, part)
        for k in want:
            g = got[k].detach().numpy()
            w = want[k].numpy()
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g / scale, w / scale, atol=tol,
                                       rtol=0, err_msg=f"{what} {part}.{k}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_elbo_and_gradients_match_jax(name):
    jm, tm, params, labels = _models(name)
    x, eps, y = _batch(jm, labels)
    num_iter = 100
    elbo_j, grads_j = _jax_elbo_and_grads(jm, params, x, eps, y, num_iter)
    elbo_t = _port_elbo(tm, x, eps, y, num_iter)
    elbo_t.backward()
    np.testing.assert_allclose(float(elbo_t.detach()), elbo_j, rtol=TOL)
    _assert_trees(_named_grads(tm), vae_from_jax(grads_j, tm.metadict),
                  TOL, "grad")


@pytest.mark.parametrize("name", ["rvae", "vae"])
def test_one_adam_step_matches_optax(name):
    jm, tm, params, labels = _models(name)
    x, eps, y = _batch(jm, labels, seed=1)
    _, grads_j = _jax_elbo_and_grads(jm, params, x, eps, y, 0)
    tx = optax.adam(LR)
    neg = jax.tree.map(lambda g: -g, grads_j)
    updates, _ = tx.update(neg, tx.init(params), params)
    stepped = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    tm.compile_trainer((x, y), training_cycles=1, batch_size=len(x))
    tm.optimizer.zero_grad()
    (-_port_elbo(tm, x, eps, y, 0)).backward()
    tm.optimizer.step()
    enc, dec = vae_from_jax(stepped, tm.metadict)
    for net, want in ((tm.encoder_net, enc), (tm.decoder_net, dec)):
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)


def test_sgd_epoch_matches_optax():
    """``optimizer="sgd"``: an epoch of plain SGD(1e-4) steps over the same
    batches, in order, from the same weights, gives the JAX trainer's
    ``optax.sgd(1e-4)`` parameters."""
    jm, tm, params, labels = _models("rvae_skip")    # rVAE((8, 8))
    batches = [_batch(jm, labels, seed=s) for s in range(4)]
    tx = optax.sgd(LR)
    opt_state = tx.init(params)
    for x, eps, y in batches:
        _, grads_j = _jax_elbo_and_grads(jm, params, x, eps, y, 0)
        neg = jax.tree.map(lambda g: -g, grads_j)
        updates, opt_state = tx.update(neg, opt_state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    X = np.concatenate([b[0] for b in batches])
    tm.compile_trainer((X, None), training_cycles=1, batch_size=len(X) // 4,
                       optimizer="sgd")
    assert type(tm.optimizer) is torch.optim.SGD
    for x, eps, y in batches:
        tm.optimizer.zero_grad()
        (-_port_elbo(tm, x, eps, y, 0)).backward()
        tm.optimizer.step()
    enc, dec = vae_from_jax(params, tm.metadict)
    for net, want in ((tm.encoder_net, enc), (tm.decoder_net, dec)):
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)


def test_trainer_options_optimizer_mesh_remat(tmp_path):
    X = np.random.RandomState(0).rand(16, 8, 8).astype(np.float32)
    m = aoi.models.rVAE((8, 8), numhidden_encoder=8, numhidden_decoder=8,
                        device="cpu")
    m.fit(X, training_cycles=1, batch_size=8, optimizer="sgd",
          filename=str(tmp_path / "sgd"), verbose=False)
    assert type(m.optimizer) is torch.optim.SGD
    assert m.optimizer.defaults["lr"] == LR
    assert m.optimizer.defaults["momentum"] == 0
    made = []
    m = aoi.models.VAE((8, 8), numhidden_encoder=8, numhidden_decoder=8,
                       device="cpu")
    m.compile_trainer((X, None), optimizer=lambda p: made.append(
        torch.optim.SGD(p, lr=0.5)) or made[-1])
    assert m.optimizer is made[0]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        aoi.models.VAE((8, 8), device="cpu").compile_trainer(
            (X, None), optimizer="lbfgs")
    for kw, item in (({"mesh": object()}, "#21"), ({"remat": True}, "#22")):
        with pytest.raises(NotImplementedError, match=item):
            aoi.models.VAE((8, 8), device="cpu").compile_trainer((X, None),
                                                                 **kw)


@pytest.mark.parametrize("im_dim", [(32, 32), (28, 28), (12, 20)])
def test_imcoordgrid_matches_jax(im_dim):
    """Same layout (x over rows from -1 to 1, y over columns from 1 to -1,
    ij meshgrid). The port's values are the correctly rounded ones; XLA's
    float32 linspace lands up to 2 ulp of 1.0 (2.4e-7) away from them."""
    got = aoi.utils.imcoordgrid(im_dim).numpy()
    want = np.asarray(jcoords.imcoordgrid(im_dim))
    assert got.shape == want.shape == (im_dim[0] * im_dim[1], 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    exact = np.stack(np.meshgrid(np.linspace(-1, 1, im_dim[0]),
                                 np.linspace(1, -1, im_dim[1]),
                                 indexing="ij")).reshape(2, -1).T
    np.testing.assert_array_equal(got, exact.astype(np.float32))


@pytest.mark.parametrize("dx", ["shift", "zero"])
def test_transform_coordinates_matches_jax(dx):
    """The same rotation rows and the same product; each output is a sum
    of two products, which XLA:CPU may round once (fused multiply-add)
    where torch rounds twice: 1 ulp of values below 2 (2.4e-7)."""
    rng = np.random.RandomState(3)
    c = rng.uniform(-1, 1, (4, 50, 2)).astype(np.float32)
    phi = rng.randn(4).astype(np.float32)
    shift = (rng.randn(4, 1, 2) * 0.1).astype(np.float32) \
        if dx == "shift" else 0
    want = np.asarray(jcoords.transform_coordinates(c, phi, shift))
    got = aoi.utils.transform_coordinates(
        torch.from_numpy(c), torch.from_numpy(phi),
        torch.from_numpy(shift) if dx == "shift" else 0).numpy()
    assert np.abs(want).max() < 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def _loss_inputs():
    rng = np.random.RandomState(4)
    x = rng.rand(5, 6, 6).astype(np.float32)
    xr = rng.randn(5, 6, 6).astype(np.float32)
    mu = rng.randn(5, 4).astype(np.float32)
    lsd = (rng.randn(5, 4) * 0.3).astype(np.float32)
    alphas = [np.abs(rng.rand(5, k)).astype(np.float32) for k in (3, 2)]
    alphas = [a / a.sum(1, keepdims=True) for a in alphas]
    return x, xr, mu, lsd, alphas


LOSSES = {
    "recon_mse": lambda m, x, xr, mu, lsd, al, t: m.reconstruction_loss(
        "mse", (6, 6), x, xr),
    "recon_ce_logits": lambda m, x, xr, mu, lsd, al, t: m.reconstruction_loss(
        "ce", (6, 6), x, xr),
    "recon_ce_probs": lambda m, x, xr, mu, lsd, al, t: m.reconstruction_loss(
        "ce", (6, 6), x, 1 / (1 + np.exp(-xr)) if not t else
        torch.sigmoid(xr), logits=False),
    "kld_normal": lambda m, x, xr, mu, lsd, al, t: m.kld_normal([mu, lsd]),
    "kld_normal_p": lambda m, x, xr, mu, lsd, al, t: m.kld_normal(
        [mu, lsd], [mu * 0.5 + 0.1, lsd * 0.7 - 0.2]),
    "kld_discrete": lambda m, x, xr, mu, lsd, al, t: m.kld_discrete(al[0]),
    "kld_rot": lambda m, x, xr, mu, lsd, al, t: m.kld_rot(0.3, lsd[:, 0]),
    "vae_loss": lambda m, x, xr, mu, lsd, al, t: m.vae_loss(
        "mse", (6, 6), x, xr, mu, lsd),
    "vae_loss_capacity": lambda m, x, xr, mu, lsd, al, t: m.vae_loss(
        "ce", (6, 6), x, xr, mu, lsd, capacity=[5.0, 1000, 30],
        num_iter=300),
    "rvae_loss": lambda m, x, xr, mu, lsd, al, t: m.rvae_loss(
        "mse", (6, 6), x, xr, mu, lsd, phi_prior=0.2),
    "rvae_loss_capacity": lambda m, x, xr, mu, lsd, al, t: m.rvae_loss(
        "mse", (6, 6), x, xr, mu, lsd, capacity=[2.0, 100, 10],
        num_iter=500),
    "joint_vae_loss": lambda m, x, xr, mu, lsd, al, t: m.joint_vae_loss(
        "mse", (6, 6), x, xr, mu, lsd, al, num_iter=2000),
    "joint_rvae_loss": lambda m, x, xr, mu, lsd, al, t: m.joint_rvae_loss(
        "ce", (6, 6), x, xr, mu, lsd, al, num_iter=40000,
        disc_capacity=[0.5, 100, 3]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    x, xr, mu, lsd, alphas = _loss_inputs()
    want = np.asarray(LOSSES[name](jl, x, xr, mu, lsd, alphas, False))
    t = [torch.from_numpy(a) for a in (x, xr, mu, lsd)]
    got = LOSSES[name](tl, *t, [torch.from_numpy(a) for a in alphas],
                       True).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_vae_nets_names_and_shapes_match_jax(name):
    """Every JAX param has its port counterpart with the shape torch
    wants, and no port param is left over (strict load)."""
    _, tm, params, _ = _models(name)
    enc, dec = vae_from_jax(params, tm.metadict)
    for net, state in ((tm.encoder_net, enc), (tm.decoder_net, dec)):
        own = net.state_dict()
        assert set(own) == set(state)
        for k in own:
            assert own[k].shape == state[k].shape, k
    n_jax = sum(a.size for a in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tm.parameters())


def test_init_draws_torch_default_bounds():
    """Weights and biases from U(+-1/sqrt(fan_in)) (the JAX package's
    ``init_kwargs``); the coord-latent ``fc_latent`` has no bias."""
    enc, dec, _ = init_VAE_nets((16, 16), 2, coord=3)
    g = generator_from_seed(0)
    init_weights_(enc, g)
    init_weights_(dec, g)
    for net in (enc, dec):
        for m in net.modules():
            if isinstance(m, torch.nn.Linear):
                bound = m.in_features ** -0.5
                for p in (m.weight, m.bias):
                    if p is None:
                        continue
                    top = float(p.detach().abs().max())
                    assert top <= bound
                    if p.numel() > 100:
                        assert top > 0.9 * bound
    assert dec.coord_latent.fc_latent.bias is None
    a, b = fcEncoderNet((4, 4), 2), fcEncoderNet((4, 4), 2)
    init_weights_(a, generator_from_seed(3))
    init_weights_(b, generator_from_seed(3))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k


def test_vae_from_jax_rejects_a_tree_that_does_not_fit():
    _, tm, params, _ = _models("rvae")
    bad = {"encoder": dict(params["encoder"]), "decoder": params["decoder"]}
    del bad["encoder"]["Dense_3"]
    with pytest.raises(ValueError, match="encoder"):
        vae_from_jax(bad, tm.metadict)
    # discrete latents are ported: a jrVAE's metadict asks for the
    # discrete head (Dense_4) that the rVAE's tree lacks, and the JAX
    # jrVAE's own tree of the same widths loads into the port's jrVAE
    with pytest.raises(ValueError, match="Dense_4"):
        vae_from_jax(params, dict(tm.metadict, discrete_dim=[2]))
    kw = dict(CONFIGS["rvae"][1], discrete_dim=[2])
    jm = jaoi.models.jrVAE((12, 12), seed=0, **kw)
    jm._init_params()
    jparams = jax.tree.map(np.asarray, jax.device_get(jm.params))
    port = aoi.models.jrVAE((12, 12), seed=0, device="cpu", **kw)
    enc, dec = vae_from_jax(jparams, port.metadict)
    assert {k for k in enc if k.startswith("fc13.")} == {"fc13.0.weight",
                                                         "fc13.0.bias"}
    port.load_jax_params(jparams)


def _patches(n=64, size=16):
    imgs, _, _ = aoi.utils.make_lattice_stack(n_images=2, size=64,
                                              spacing=12, seed=3)
    return np.concatenate([aoi.utils.extract_patches_2d(
        p, (size, size), n // 2, i) for i, p in enumerate(imgs)])


def test_rvae_fit_trains_saves_reloads_and_serves(tmp_path):
    X = _patches()
    kw = dict(numhidden_encoder=64, numhidden_decoder=64, device="cpu")
    m = aoi.models.rVAE((16, 16), latent_dim=2, **kw)
    fname = str(tmp_path / "rvae")
    log = str(tmp_path / "run.jsonl")
    m.fit(X, training_cycles=2, batch_size=16, filename=fname,
          verbose=False, metrics_log=log)
    hist = m.loss_history["train_loss"]
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert hist[1] > hist[0]
    assert m.num_iter == 2 * (64 // 16)
    lines = [json.loads(s) for s in open(log)]
    assert [r["cycle"] for r in lines] == [0, 1]
    np.testing.assert_allclose([r["train_elbo"] for r in lines], hist)

    meta, arrays = checkpoint.load_checkpoint(fname)
    assert meta["vae_type"] == "rVAE" and meta["num_iter"] == 8
    assert tuple(meta["in_dim"]) == (16, 16)
    m2 = aoi.models.rVAE((16, 16), latent_dim=2, seed=7, **kw)
    m2.load_weights(fname)
    z = np.random.RandomState(0).randn(5, 2)
    np.testing.assert_array_equal(m2.decode(z), m.decode(z))

    z_mean, z_logsd = m.encode(X[:10])
    assert z_mean.shape == z_logsd.shape == (10, 5)
    rec = m.reconstruct(X[:3], num_samples=4)
    assert rec.shape == (12, 16, 16) and np.isfinite(rec).all()
    fig = m.manifold2d(d=3)
    assert fig.shape == (48, 48) and np.isfinite(fig).all()


def test_same_seed_same_weights_and_training(tmp_path):
    X = _patches(32, 8)
    runs = []
    for seed, name in ((3, "a"), (3, "b"), (4, "c")):
        m = aoi.models.rVAE((8, 8), seed=seed, numhidden_encoder=16,
                            numhidden_decoder=16, device="cpu")
        w0 = [p.detach().clone() for p in m.parameters()]
        m.fit(X, training_cycles=2, batch_size=8, verbose=False,
              filename=str(tmp_path / name))
        runs.append((w0, m.loss_history["train_loss"]))
    for p, q in zip(runs[0][0], runs[1][0]):
        assert torch.equal(p, q)
    assert runs[0][1] == runs[1][1]
    assert not torch.equal(runs[0][0][0], runs[2][0][0])


def test_vae_fit_with_labels_and_test_set(tmp_path):
    X = _patches(32, 8)
    y = np.arange(32) % 2
    m = aoi.models.VAE((8, 8), nb_classes=2, numhidden_encoder=16,
                       numhidden_decoder=16, device="cpu")
    m.fit(X[:24], y[:24], X[24:], y[24:], training_cycles=2, batch_size=8,
          filename=str(tmp_path / "vae"), verbose=False)
    assert len(m.loss_history["test_loss"]) == 2
    assert np.isfinite(m.loss_history["test_loss"]).all()
    assert m.decode(np.zeros((2, 2)), 1).shape == (2, 8, 8)
    assert m.manifold2d(d=2).shape == (16, 16)
    with pytest.raises(RuntimeError, match="nb_classes"):
        m.fit(X, np.zeros(32, int), training_cycles=1)


def test_checkpoints_round_trip_sync_and_async(tmp_path):
    arrays = {"params": {"a": torch.arange(6.0).reshape(2, 3),
                         "b": {"c": np.ones(4, np.float32)}}}
    meta = {"model_type": "vae", "n": np.int64(3), "f": np.float32(0.5)}
    p = checkpoint.save_checkpoint(str(tmp_path / "sync"), meta, arrays)
    assert p.endswith(".aoit") and not os.listdir(tmp_path)[0].endswith(
        ".tmp")
    got_meta, got = checkpoint.load_checkpoint(p)
    assert got_meta == {"model_type": "vae", "n": 3, "f": 0.5}
    assert torch.equal(got["params"]["a"], arrays["params"]["a"])
    # an async save snapshots now: later in-place updates are not written
    live = torch.zeros(3)
    checkpoint.save_checkpoint_async(str(tmp_path / "async"), meta,
                                     {"w": live})
    live += 1
    checkpoint.flush_async_checkpoints()
    _, got = checkpoint.load_checkpoint(str(tmp_path / "async"))
    assert torch.equal(got["w"], torch.zeros(3))
    # a failed background write is raised by the flush
    checkpoint.save_checkpoint_async(str(tmp_path / "missing" / "x"), meta,
                                     {"w": live})
    with pytest.raises(FileNotFoundError):
        checkpoint.flush_async_checkpoints()


def _fixture_script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_torch_port_fixtures",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rvae_fixture_is_current_and_port_matches_it():
    """The card's config C fixture equals a fresh JAX run, and the port
    reproduces its ELBO, gradients and Adam step on the CPU."""
    script = _fixture_script()
    stored = dict(np.load(script.RVAE_FIXTURE))
    fresh = script.make_rvae_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith("params/") or k in ("x", "eps"):
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
        else:
            # XLA:CPU on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    m = aoi.models.rVAE((32, 32), latent_dim=2, device="cpu")
    m.load_jax_params(script.unflatten(stored, "params"))
    m.dx_prior = 0.1
    m.kdict_["phi_prior"] = 0.1
    m.compile_trainer((stored["x"], None), training_cycles=1,
                      batch_size=script.RVAE_BATCH)
    m.optimizer.zero_grad()
    elbo = _port_elbo(m, stored["x"], stored["eps"], None, 0)
    (-elbo).backward()
    np.testing.assert_allclose(float(elbo.detach()), float(stored["elbo"]),
                               rtol=TOL)
    enc_g, dec_g = _named_grads(m)    # of -ELBO; the fixture's are of ELBO
    _assert_trees(({k: -g for k, g in enc_g.items()},
                   {k: -g for k, g in dec_g.items()}),
                  vae_from_jax(script.unflatten(stored, "grads"), m.metadict),
                  FIXTURE_TOL, "grad")
    m.optimizer.step()
    enc, dec = vae_from_jax(script.unflatten(stored, "adam"), m.metadict)
    _assert_trees(({k: v for k, v in m.encoder_net.state_dict().items()},
                   {k: v for k, v in m.decoder_net.state_dict().items()}),
                  (enc, dec), 1e-6, "adam")
