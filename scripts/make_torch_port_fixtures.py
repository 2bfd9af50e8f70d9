"""Writes the JAX-made fixture that the PyTorch port is held against where
JAX cannot run (on the GPU machine).

``tests/fixtures/torch_port_unet_fwd.npz`` holds:
- the variables of the full-width JAX Unet (nb_filters 16, layers
  (1, 2, 2, 3), one class) initialised with ``jax.random.key(0)``, with the
  BatchNorm statistics and affine parameters redrawn from numpy seed 0 so
  that the fixture exercises their mapping; flattened to ``/``-joined keys
  under ``params/`` and ``batch_stats/``;
- ``x``: a (2, 64, 64, 1) float32 input drawn from numpy seed 0;
- ``y``: the JAX float32 output logits (2, 64, 64, 1).

Run on the CPU: ``python scripts/make_torch_port_fixtures.py``.
``tests/test_torch_nets.py`` regenerates the contents and compares them
with the file, so the fixture cannot go stale.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_unet_fwd.npz")


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


def main():
    arrays = make_fixture()
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez(FIXTURE, **arrays)
    n_bytes = sum(a.nbytes for a in arrays.values())
    print(f"wrote {FIXTURE}: {len(arrays)} arrays, {n_bytes} bytes")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
