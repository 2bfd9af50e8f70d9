"""Writes the JAX-made fixtures that the PyTorch port is held against where
JAX cannot run (on the GPU machine).

``tests/fixtures/torch_port_unet_fwd.npz`` holds:
- the variables of the full-width JAX Unet (nb_filters 16, layers
  (1, 2, 2, 3), one class) initialised with ``jax.random.key(0)``, with the
  BatchNorm statistics and affine parameters redrawn from numpy seed 0 so
  that the fixture exercises their mapping; flattened to ``/``-joined keys
  under ``params/`` and ``batch_stats/``;
- ``x``: a (2, 64, 64, 1) float32 input drawn from numpy seed 0;
- ``y``: the JAX float32 output logits (2, 64, 64, 1).

``tests/fixtures/torch_port_rvae_step.npz`` holds one training step of the
rVAE at bench config C's width (`bench.py:291-327`): ``rVAE((32, 32),
latent_dim=2)`` (seed 0) with
- ``params/...``: its initial JAX params, flattened as above;
- ``x``: 128 of config C's 1024 patches of 32x32 (every 8th), cut from
  ``make_lattice_stack(n_images=2, size=256, spacing=16, seed=3)``;
- ``eps``: the (128, 5) reparameterisation noise, numpy seed 0;
- ``elbo``: the ELBO of that batch (``num_iter`` 0, both priors 0.1);
- ``grads/...``: the ELBO's gradient with respect to every param;
- ``adam/...``: the params after one ``optax.adam(1e-4)`` step on -ELBO.

Run on the CPU: ``python scripts/make_torch_port_fixtures.py``.
``tests/test_torch_nets.py`` and ``tests/test_torch_vae.py`` regenerate
the contents and compare them with the files, so the fixtures cannot go
stale.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_unet_fwd.npz")
RVAE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                            "torch_port_rvae_step.npz")
RVAE_BATCH = 128


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def unflatten(arrays, prefix):
    """Nested dict of the arrays whose keys start with ``prefix/``."""
    tree = {}
    for key, v in arrays.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def make_fixture():
    """The fixture's arrays, computed with the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.nets import Unet

    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 64, 1).astype(np.float32)
    net = Unet(nb_classes=1, nb_filters=16, layers=(1, 2, 2, 3))
    variables = jax.device_get(net.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.asarray(x), False))
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    stats = jax.tree.map(np.asarray, dict(variables["batch_stats"]))

    def redraw_batch_norms(p, s):
        for k in sorted(p):
            if k.startswith("BatchNorm_"):
                c = p[k]["scale"].shape
                p[k] = {"scale": 1 + 0.2 * rng.randn(*c),
                        "bias": 0.2 * rng.randn(*c)}
                s[k] = {"mean": 0.2 * rng.randn(*c),
                        "var": 0.5 + rng.rand(*c)}
            elif isinstance(p[k], dict):
                redraw_batch_norms(p[k], s.setdefault(k, {}))

    redraw_batch_norms(params, stats)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), stats)
    with jax.default_matmul_precision("highest"):
        y = np.asarray(net.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), False))
    out = {"x": x, "y": y}
    out.update(flatten(params, "params"))
    out.update(flatten(stats, "batch_stats"))
    return out


def config_c_patches():
    """Bench config C's 1024 patches of 32x32 (`bench.py:300-304`)."""
    from atomai_tpu_torch.utils import extract_patches_2d, make_lattice_stack
    images, _, _ = make_lattice_stack(n_images=2, size=256, spacing=16,
                                      seed=3)
    return np.concatenate([extract_patches_2d(p, (32, 32), 512, i)
                           for i, p in enumerate(images)])


def make_rvae_fixture():
    """One rVAE training step at config C's width, computed with the JAX
    package on the CPU in float32."""
    import jax
    import jax.numpy as jnp
    import optax
    jax.config.update("jax_platforms", "cpu")
    import atomai_tpu as aoi

    x = config_c_patches()[::8][:RVAE_BATCH]
    eps = np.random.RandomState(0).randn(RVAE_BATCH, 5).astype(np.float32)
    m = aoi.models.rVAE((32, 32), latent_dim=2)
    m._init_params()
    m.dx_prior = 0.1
    m.kdict_["phi_prior"] = 0.1
    # the noise comes from the fixture, not from a JAX key
    m.reparameterize = lambda key, mu, sd: mu + sd * jnp.asarray(eps)
    params = jax.tree.map(np.asarray, jax.device_get(m.params))

    def elbo_fn(p):
        return m.forward_compute_elbo_fn(p, jnp.asarray(x), None,
                                         jax.random.key(0), 0, True)

    with jax.default_matmul_precision("highest"):
        elbo, grads = jax.value_and_grad(elbo_fn)(params)
    tx = optax.adam(1e-4)
    neg = jax.tree.map(lambda g: -g, grads)
    updates, _ = tx.update(neg, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    out = {"x": x.astype(np.float32), "eps": eps,
           "elbo": np.asarray(elbo, np.float32)}
    for prefix, tree in (("params", params), ("grads", grads),
                         ("adam", stepped)):
        out.update(flatten(jax.tree.map(np.asarray, tree), prefix))
    return out


def main():
    for path, make in ((FIXTURE, make_fixture),
                       (RVAE_FIXTURE, make_rvae_fixture)):
        arrays = make()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **arrays)
        n_bytes = sum(a.nbytes for a in arrays.values())
        print(f"wrote {path}: {len(arrays)} arrays, {n_bytes} bytes")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
