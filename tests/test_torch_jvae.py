"""The port's joint VAEs (jVAE, jrVAE), its conv decoder and its 1D conv
encoder against the JAX package's.

With the JAX params carried over by ``vae_from_jax``, the same numpy batch,
the same Gaussian noise and the same Gumbel uniforms (the JAX side gets
them by replacing ``reparameterize`` and ``reparameterize_discrete`` on the
instance, the latter with ``jax.random.uniform`` made to return the given
array), both packages give the same ELBO and the same gradient of every
parameter, in float32 on the CPU: 1e-5 relative (gradients after dividing
by each tensor's scale). One Adam step from there gives the same
parameters. The joint losses agree at capacity schedules before, during
and past their ramps. Each JAX run is made once, for the whole module.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import atomai_tpu as jaoi
from atomai_tpu.losses_metrics import vi_losses as jl
import atomai_tpu_torch as aoi
from atomai_tpu_torch.losses_metrics import vi_losses as tl
from atomai_tpu_torch.models import vae_from_jax

torch.set_num_threads(1)

TOL = 1e-5
LR = 1e-4
NUM_ITER = 150
CAP = dict(cont_capacity=[4.0, 200, 20], disc_capacity=[1.5, 100, 10])

# (class name, constructor kwargs, in_dim, labels): small widths
CONFIGS = {
    "jvae": ("jVAE", dict(discrete_dim=[3], numhidden_encoder=24,
                          numhidden_decoder=24), (10, 10), False),
    "jvae_conv_encoder": ("jVAE", dict(discrete_dim=[3], conv_encoder=True,
                                       numhidden_encoder=4,
                                       numlayers_encoder=1,
                                       numhidden_decoder=16), (8, 8), False),
    "jvae_two_discrete": ("jVAE", dict(discrete_dim=[3, 2],
                                       numhidden_encoder=16,
                                       numhidden_decoder=16, **CAP), (8, 8),
                          False),
    "jvae_classes": ("jVAE", dict(discrete_dim=[2], nb_classes=2,
                                  numhidden_encoder=16, numhidden_decoder=16,
                                  temperature=0.4), (8, 8), True),
    "jrvae": ("jrVAE", dict(discrete_dim=[4], numhidden_encoder=32,
                            numhidden_decoder=32), (12, 12), False),
    "jrvae_no_translation": ("jrVAE", dict(discrete_dim=[3],
                                           translation=False,
                                           numhidden_decoder=16, **CAP),
                             (8, 8), False),
    "vae_conv_decoder": ("VAE", dict(conv_decoder=True, numhidden_encoder=16,
                                     numhidden_decoder=4), (8, 8), False),
    "vae_conv_decoder_channels": ("VAE", dict(conv_decoder=True,
                                              numhidden_encoder=16,
                                              numhidden_decoder=4,
                                              numlayers_decoder=1),
                                  (6, 6, 2), False),
    "vae_conv_decoder_1d": ("VAE", dict(conv_decoder=True,
                                        numhidden_encoder=16,
                                        numhidden_decoder=4), (20,), False),
    "vae_conv_encoder_1d": ("VAE", dict(conv_encoder=True,
                                        numhidden_encoder=4,
                                        numhidden_decoder=16), (20,), False),
    "jvae_conv_both_1d": ("jVAE", dict(discrete_dim=[2], conv_encoder=True,
                                       conv_decoder=True,
                                       numhidden_encoder=4,
                                       numhidden_decoder=4), (16,), False),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The JAX model and its initial params (numpy), made once."""
    cls, kwargs, in_dim, _ = CONFIGS[name]
    jm = getattr(jaoi.models, cls)(in_dim, seed=0, **kwargs)
    jm._init_params()
    if jm.coord:
        jm.dx_prior = 0.1
        jm.kdict_["phi_prior"] = 0.1
    return jm, jax.tree.map(np.asarray, jax.device_get(jm.params))


def _models(name):
    """(JAX model, port model with the JAX params, params, labels)."""
    cls, kwargs, in_dim, labels = CONFIGS[name]
    jm, params = _jax_model(name)
    tm = getattr(aoi.models, cls)(in_dim, seed=0, device="cpu", **kwargs)
    tm.load_jax_params(params)
    if tm.coord:
        tm.dx_prior = 0.1
        tm.kdict_["phi_prior"] = 0.1
    return jm, tm, params, labels


def _batch(jm, labels, b=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, *jm.in_dim).astype(np.float32)
    cont = jm.z_dim - sum(jm.discrete_dim or [])
    eps = rng.randn(b, cont).astype(np.float32)
    us = [rng.rand(b, k).astype(np.float32) for k in jm.discrete_dim or []]
    y = rng.randint(0, 2, b) if labels else None
    return x, eps, us, y


def inject_noise(jm, eps, us):
    """The JAX model draws ``eps`` and, head by head, ``us``."""
    jm.reparameterize = lambda key, mu, sd: mu + sd * jnp.asarray(eps)
    calls = []

    def discrete(key, alpha, tau):
        u = jnp.asarray(us[len(calls) % len(us)])
        calls.append(1)
        with mock.patch.object(jax.random, "uniform", lambda *a, **k: u):
            return type(jm).reparameterize_discrete(key, alpha, tau)

    jm.reparameterize_discrete = discrete


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """(params, batch, ELBO, gradients, params after one Adam step) of the
    JAX model, made once."""
    jm, params = _jax_model(name)
    x, eps, us, y = _batch(jm, CONFIGS[name][3])
    inject_noise(jm, eps, us)

    def elbo_fn(p):
        return jm.forward_compute_elbo_fn(
            p, jnp.asarray(x), None if y is None else jnp.asarray(y),
            jax.random.key(0), NUM_ITER, True)

    with jax.default_matmul_precision("highest"):
        elbo, grads = jax.jit(jax.value_and_grad(elbo_fn))(params)
    grads = jax.tree.map(np.asarray, grads)
    tx = optax.adam(LR)
    neg = jax.tree.map(lambda g: -g, grads)
    updates, _ = tx.update(neg, tx.init(params), params)
    stepped = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    return params, (x, eps, us, y), float(elbo), grads, stepped


def _port_elbo(tm, batch, num_iter=NUM_ITER):
    x, eps, us, y = batch
    kw = {"u": [torch.from_numpy(u) for u in us]} if us else {}
    return tm.forward_compute_elbo(
        torch.from_numpy(x), None if y is None else torch.from_numpy(y),
        num_iter, eps=torch.from_numpy(eps), **kw)


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
    _, tm, _, _ = _models(name)
    _, batch, elbo_j, grads_j, _ = jax_run(name)
    elbo_t = _port_elbo(tm, batch)
    elbo_t.backward()
    np.testing.assert_allclose(float(elbo_t.detach()), elbo_j, rtol=TOL)
    _assert_trees(({k: p.grad for k, p in tm.encoder_net.named_parameters()},
                   {k: p.grad for k, p in tm.decoder_net.named_parameters()}),
                  vae_from_jax(grads_j, tm.metadict), TOL, "grad")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_adam_step_matches_optax(name):
    _, tm, _, _ = _models(name)
    _, batch, _, _, stepped = jax_run(name)
    tm.compile_trainer((batch[0], batch[3]), training_cycles=1,
                       batch_size=len(batch[0]))
    tm.optimizer.zero_grad()
    (-_port_elbo(tm, batch)).backward()
    tm.optimizer.step()
    enc, dec = vae_from_jax(stepped, tm.metadict)
    for net, want in ((tm.encoder_net, enc), (tm.decoder_net, dec)):
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_nets_names_and_shapes_match_jax(name):
    """Every JAX param has its port counterpart with the shape torch
    wants, no port param is left over, and the encoder's outputs are the
    JAX encoder's (z_mu, z_logstd and each discrete head's softmax)."""
    jm, tm, params, _ = _models(name)
    enc, dec = vae_from_jax(params, tm.metadict)
    for net, state in ((tm.encoder_net, enc), (tm.decoder_net, dec)):
        own = net.state_dict()
        assert set(own) == set(state)
        for k in own:
            assert own[k].shape == state[k].shape, k
    assert sum(a.size for a in jax.tree.leaves(params)) == sum(
        p.numel() for p in tm.parameters())
    x = jax_run(name)[1][0]
    want = jm.encoder_net.apply({"params": params["encoder"]},
                                jnp.asarray(x), False)
    got = tm.encoder_net(torch.from_numpy(x))
    assert len(got) == len(want) == 2 + len(jm.discrete_dim or [])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def _loss_inputs():
    rng = np.random.RandomState(4)
    x = rng.rand(5, 6, 6).astype(np.float32)
    xr = rng.randn(5, 6, 6).astype(np.float32)
    mu = rng.randn(5, 4).astype(np.float32)
    lsd = (rng.randn(5, 4) * 0.3).astype(np.float32)
    alphas = [rng.rand(5, k).astype(np.float32) + 0.05 for k in (3, 2, 4)]
    return x, xr, mu, lsd, [a / a.sum(1, keepdims=True) for a in alphas]


@pytest.mark.parametrize("num_iter", [0, 37, 100, 250, 40000])
@pytest.mark.parametrize("loss", ["joint_vae_loss", "joint_rvae_loss"])
def test_joint_losses_along_capacity_schedules(loss, num_iter):
    """Both capacities ramp linearly to their maxima over ``num_iters``
    (the discrete one capped by sum(log k)); beyond the ramp they hold."""
    x, xr, mu, lsd, alphas = _loss_inputs()
    kw = dict(cont_capacity=[3.0, 200, 25], disc_capacity=[9.0, 100, 7],
              num_iter=num_iter)
    if loss == "joint_rvae_loss":
        kw["phi_prior"] = 0.3
    want = float(getattr(jl, loss)("mse", (6, 6), x, xr, mu, lsd, alphas,
                                   **kw))
    got = float(getattr(tl, loss)(
        "mse", (6, 6), *[torch.from_numpy(a) for a in (x, xr, mu, lsd)],
        [torch.from_numpy(a) for a in alphas], **kw))
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_infocapacity_matches_jax_with_a_traced_num_iter():
    """The JAX trainers pass ``num_iter`` as a traced int32; the port's
    Python number gives the same capacity terms."""
    kl_c, kl_d = np.float32(2.7), np.float32(0.9)
    for it in (0, 99, 1000, 123456):
        want = jax.jit(lambda n: jl.infocapacity(
            kl_c, [5.0, 25000, 30], kl_d, [5.0, 25000, 30], [4, 3], n))(
            jnp.int32(it))
        got = tl.infocapacity(torch.tensor(kl_c), [5.0, 25000, 30],
                              torch.tensor(kl_d), [5.0, 25000, 30], [4, 3],
                              it)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=TOL)


def _patches(n=48, size=12):
    imgs, _, _ = aoi.utils.make_lattice_stack(n_images=2, size=48,
                                              spacing=12, seed=3)
    return np.concatenate([aoi.utils.extract_patches_2d(
        p, (size, size), n // 2, i) for i, p in enumerate(imgs)])


@pytest.mark.parametrize("cls", ["jVAE", "jrVAE"])
def test_joint_fit_trains_and_serves(cls, tmp_path):
    X = _patches()
    m = getattr(aoi.models, cls)((12, 12), latent_dim=2, discrete_dim=[3],
                                 numhidden_encoder=32, numhidden_decoder=32,
                                 device="cpu")
    m.fit(X, training_cycles=3, batch_size=12, verbose=False,
          filename=str(tmp_path / "m"), cont_capacity=[2.0, 50, 30])
    hist = m.loss_history["train_loss"]
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert m.kdict_["cont_capacity"] == [2.0, 50, 30]
    assert m.num_iter == 3 * 4
    z_mean, z_logsd, alphas = m.encode(X[:7])
    cont = 2 + m.coord
    assert z_mean.shape == z_logsd.shape == (7, cont)
    assert alphas.shape == (7, 3)
    np.testing.assert_allclose(alphas.sum(1), 1, rtol=1e-6)
    rec = m.reconstruct(X[:2], num_samples=3)
    assert rec.shape == (6, 12, 12) and np.isfinite(rec).all()
    rec1 = m.reconstruct(X[:2], num_samples=3, label=1)
    assert rec1.shape == (6, 12, 12) and not np.allclose(rec1, rec)
    for idx in range(3):
        fig = m.manifold2d(d=2, disc_idx=idx)
        assert fig.shape == (24, 24) and np.isfinite(fig).all()
    grid = m.manifold_traversal(1, d=4)
    assert grid.shape == (3 * 14, 4 * 14 + 2)
    assert np.isfinite(grid).all() and grid.min() >= 0 and grid.max() <= 1
    with pytest.raises(TypeError, match="joint"):
        aoi.models.VAE((12, 12), device="cpu").manifold_traversal(0)
