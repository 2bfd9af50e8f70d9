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

``tests/fixtures/torch_port_seg_train.npz`` holds a short training run of
the JAX ``Segmentor`` at bench config A's width (nb_filters 16, layers
(1, 2, 2, 3), one class), started from the variables of
``torch_port_unet_fwd.npz`` (not stored again):
- ``x_train``, ``y_train`` (uint8), ``x_test``, ``y_test``: frames 0-7 and
  8-9 of the JAX package's ``make_lattice_stack(n_images=10, size=64,
  spacing=12, seed=0)``;
- ``schedule``: the batch order of the 5 cycles (seed 1, 2 batches of 4);
- ``train_loss``, ``test_loss``: the per-cycle losses of ``fit(...,
  training_cycles=5, batch_size=4)`` with Adam(1e-3), float32 at the
  highest matmul precision;
- ``final/...``: the trained ``ConvBlock_0`` (c1) and ``Conv_0`` (px)
  variables, params and BatchNorm statistics, flattened as above.

``tests/fixtures/torch_port_imspec.npz`` holds a short training run of the
JAX ``ImSpec`` at bench config B's width (`bench.py:340-355`):
``ImSpec((64, 64), (16,), latent_dim=2)`` with default widths, on config
B's data (``RandomState(0)``: 512 images of 64x64, then 512 spectra of 16;
:func:`config_b_data`, not stored), the first 64 pairs as the test set:
- ``shape/...``: the shape of every variable; the variables themselves are
  drawn from numpy seed 0 by :func:`seeded_variables` (not stored: the
  encoder's Dense kernel alone is 2 MB);
- ``schedule``: the batch order of the 3 cycles (batch 32, seed 1);
- ``train_loss``, ``test_loss``: the per-cycle losses of ``fit(...,
  training_cycles=3, batch_size=32)`` with Adam(1e-3), float32 at the
  highest matmul precision;
- ``predict``: the trained model's ``predict`` of the first 8 images;
- ``final/...``: the trained encoder ``ConvBlock_0`` and the decoder's
  ``Dense_0``, ``ConvBlock_0`` and ``Conv_0``, params and BatchNorm
  statistics.

``tests/fixtures/torch_port_ensemble.npz`` holds a JAX
``EnsembleTrainer("Unet", 1).train_ensemble_from_baseline`` run (the JAX
package's "vmap" member layout, float32) of 2 members for 3 cycles of
batch 4, nb_filters 4 and layers (1, 1, 1, 1), on 12 frames of 32x32
(frames 0-9 to train, 10-11 to test):
- ``x_train``, ``y_train`` (uint8), ``x_test``, ``y_test``;
- ``base/...``: the baseline's params (the JAX net initialised with
  ``jax.random.key(3)``), from which every member starts;
- ``schedules``: each member's batch order; ``train_loss``: the members'
  mean loss of each cycle;
- ``member/<i>/params/...``, ``member/<i>/batch_stats/...``: each trained
  member.

``tests/fixtures/torch_port_dklgp.npz`` holds three GP runs of the JAX
package, float32 at the highest matmul precision, from data that
:func:`dkl_fixture_data`, :func:`gp2d_data` and :func:`reconstruct_image`
draw with numpy (not stored):
- ``dkl_loss``, ``dkl_gp/...``, ``dkl_mean``, ``dkl_var``, ``dkl_embed``:
  ``dklGPR(64, embedim=2)`` on 512 x 64 inputs with the full-width
  extractor (64-1000-500-50-2) from numpy-drawn weights
  (:func:`dkl_fe_params`, set after ``compile_trainer`` with Adam
  restarted), 5 Adam(0.01) steps: the losses, the final raw GP
  parameters, and ``predict`` and ``embed`` of 256 fresh points;
- ``gp_<kernel_type>_loss``, ``_mean``, ``_var`` for 'exact' and
  'kissgp' (``grid_points_ratio`` 0.25): ``GPTrainer`` on 400 points in
  2D, 10 Adam(0.1) steps, and ``predict`` of 50 fresh points;
- ``reconstruct``: ``Reconstructor.reconstruct`` of a 32 x 32 image with
  half its pixels measured, 50 cycles (the exact path).

``tests/fixtures/torch_port_zoo.npz`` holds the supervised model zoo at
its default widths (:data:`ZOO_NETS`: the dilated Unet, dilnet, SegResNet,
ResHedNet, the denoiser, the regressor on every backbone and a
three-class classifier), float32 at the highest matmul precision:
- ``shape/<net>/...``: the shape of every variable of each net; the
  variables are drawn from numpy seed 0 by :func:`seeded_variables` with
  kernel gain :data:`ZOO_GAIN` (not stored: ResNet50 alone holds 23.5 M
  weights);
- ``x``: a (2, 64, 64, 1) input drawn from numpy seed 0;
- ``y/<net>``: each net's eval-mode output of ``x``;
- ``reg_schedule``, ``reg_train_loss``, ``reg_test_loss``: three
  SGD(1e-5) cycles of ``Regressor("mobilenet", 1)`` from its seeded
  variables with a fresh net's BatchNorm statistics
  (:func:`with_identity_stats`), batch 8, on :func:`zoo_reg_data` (40
  images of 64 x 64, the last 8 to test). SGD, not the default Adam: Adam
  moves every weight by lr whatever its gradient's size, so the
  rounding-size gradients of a deep net (11,172 of MobileNetV2's 2.2 M
  take either sign) would separate the two packages' weights by 2 * lr;
  SGD moves each by lr times its gradient, which holds the backward itself
  to the JAX one. A small lr keeps the three steps where the loss is
  nearly linear in them: this train-mode MobileNetV2 on 8 images is
  ill-conditioned (BatchNorms over 32 values), and the JAX package's
  float32 gradient already lies 2-7% from the float64 one;
- ``reg_final/...``: the trained variables of :data:`ZOO_REG_FINAL`.

``tests/fixtures/torch_port_jvae.npz`` holds one training step of each
joint VAE at bench config C's width (the JAX bench's pins,
`bench.py:435-449`): ``jVAE((32, 32), latent_dim=2, discrete_dim=[4])``
and ``jrVAE`` of the same arguments, float32 at the highest matmul
precision, on the 128 patches of the rVAE fixture (:func:`jvae_batch`,
not stored), at ``num_iter`` :data:`JVAE_NUM_ITER` (the capacities part
way up their ramps), both priors 0.1:
- ``shape/<model>/...``: the shape of every param; the params are drawn
  from numpy seed :data:`JVAE_SEEDS` by :func:`seeded_variables` (not
  stored);
- ``<model>/eps``: the continuous latents' normal noise and
  ``<model>/u``: the discrete latent's Gumbel uniforms, numpy seed 0;
- ``<model>/elbo``, ``<model>_grads/...``: the ELBO and its gradient;
  ``<model>_adam/...``: the params after one ``optax.adam(1e-4)`` step
  on -ELBO.

``tests/fixtures/torch_port_unet.aoi`` and ``torch_port_rvae.aoi`` are
checkpoints written by the JAX package itself (``save_model``, msgpack
payload), for the port's ``load_model`` and ``resume_training`` to read;
``tests/fixtures/torch_port_aoi.npz`` holds the JAX numbers beside them
(:func:`make_aoi_fixture`):
- ``torch_port_unet.aoi``: the JAX ``Segmentor`` of the seg-train fixture
  after its 5 cycles (config A's width, the same data and schedule),
  saved with ``include_optimizer=True`` (the optax Adam state and
  ``completed_cycles``);
- ``unet/y``: the saved net's float32 eval output of the Unet fixture's
  ``x``;
- ``unet/resume_schedule``, ``unet/resume_train_loss``,
  ``unet/resume_test_loss``: ``resume_training`` of that file for
  :data:`AOI_RESUME_CYCLES` more cycles, float32 at the highest matmul
  precision;
- ``torch_port_rvae.aoi``: ``rVAE((32, 32), latent_dim=2)`` (config C's)
  after :data:`AOI_RVAE_EPOCHS` epoch of ``fit`` on config C's 1,024
  patches, batch 128 (its ``num_iter`` and ``num_epochs`` in the meta);
- ``rvae/x``, ``rvae/z_mean``, ``rvae/z_logsd``: ``encode`` of 16 of the
  patches; ``rvae/z``, ``rvae/decoded``: ``decode`` of a 3 x 3 latent
  grid; ``rvae/manifold``: ``manifold2d(d=4)``.

Run on the CPU: ``python scripts/make_torch_port_fixtures.py``.
``tests/test_torch_aoi_fixture.py``, ``tests/test_torch_nets.py``,
``tests/test_torch_vae.py``,
``tests/test_torch_seg_train_fixture.py``,
``tests/test_torch_imspec_fixture.py``, ``tests/test_torch_ensemble.py``,
``tests/test_torch_zoo_fixture.py`` and ``tests/test_torch_jvae_fixture.py``
regenerate the contents and compare
them with the files, so the fixtures cannot go stale. ``tests/test_torch_dklgp_fixture.py`` holds the port to
``torch_port_dklgp.npz`` without regenerating it (the JAX runs take about
half a minute); ``tests/test_torch_gptrainer.py`` and
``tests/test_torch_dklgpr.py`` hold the same code paths against the JAX
package directly.
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
SEG_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                 "torch_port_seg_train.npz")
SEG_CYCLES = 5
SEG_BATCH = 4
IMSPEC_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                              "torch_port_imspec.npz")
IMSPEC_CYCLES = 3
IMSPEC_BATCH = 32
IMSPEC_PREDICT = 8
IMSPEC_FINAL = (("encoder", "ConvBlock_0"), ("decoder", "Dense_0"),
                ("decoder", "ConvBlock_0"), ("decoder", "Conv_0"))
ENSEMBLE_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                "torch_port_ensemble.npz")
ENSEMBLE = dict(n_models=2, cycles=3, batch=4, nb_filters=4,
                layers=(1, 1, 1, 1))
DKLGP_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                             "torch_port_dklgp.npz")
DKL = dict(n=512, indim=64, embedim=2, hidden=(1000, 500, 50), cycles=5,
           lr=0.01, n_predict=256)
GP2D = dict(n=400, cycles=10, n_predict=50, grid_points_ratio=0.25)
RECONSTRUCT = dict(size=32, cycles=50)
ZOO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_zoo.npz")
# name -> (kind, constructor arguments), every net at its default width
ZOO_NETS = {
    "unet_dilated": ("seg", dict(model="Unet", with_dilation=True)),
    "dilnet": ("seg", dict(model="dilnet")),
    "segresnet": ("seg", dict(model="SegResNet")),
    "reshednet": ("seg", dict(model="ResHedNet")),
    "denoiser": ("denoiser", {}),
    "reg_resnet": ("reg", dict(backbone="resnet")),
    "reg_vgg": ("reg", dict(backbone="vgg")),
    "reg_mobilenet": ("reg", dict(backbone="mobilenet")),
    "reg_resnet-slim": ("reg", dict(backbone="resnet-slim")),
    "reg_vgg-slim": ("reg", dict(backbone="vgg-slim")),
    "reg_mobilenet-slim": ("reg", dict(backbone="mobilenet-slim")),
    "cls_mobilenet": ("cls", dict(backbone="mobilenet", nb_classes=3)),
}
# kernels U(+-sqrt(6 / fan_in)): variance 2 / fan_in, so that activations
# keep their scale through the 50 layers of ResNet50 and the 13 of VGG16
ZOO_GAIN = float(np.sqrt(6.0))
ZOO_REG = dict(n=40, n_test=8, size=64, cycles=3, batch=8, lr=1e-5)
ZOO_REG_FINAL = (("ConvBackbone_0", "features", "stem_conv"),
                 ("ConvBackbone_0", "features", "stem_bn"),
                 ("ConvBackbone_0", "features", "block1", "dw"),
                 ("ConvBackbone_0", "features", "head_bn"),
                 ("Dense_0",))


JVAE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_jvae.npz")
JVAE_MODELS = {"jvae": "jVAE", "jrvae": "jrVAE"}
JVAE_SEEDS = {"jvae": 0, "jrvae": 1}
JVAE_NUM_ITER = 5000
AOI_UNET = os.path.join(ROOT, "tests", "fixtures", "torch_port_unet.aoi")
AOI_RVAE = os.path.join(ROOT, "tests", "fixtures", "torch_port_rvae.aoi")
AOI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aoi.npz")
AOI_RESUME_CYCLES = 3
AOI_RVAE_EPOCHS = 1
AOI_RVAE_BATCH = 128


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


def seeded_variables(shapes, seed=0, kernel_gain=1.0):
    """Flat variables ``{"params/...": array, "batch_stats/...": array}``
    of the given shapes, drawn from ``RandomState(seed)`` in sorted key
    order: kernels U(+-kernel_gain/sqrt(fan_in)), biases U(+-0.1), BatchNorm scales
    1 + 0.1 N(0, 1), running means 0.1 N(0, 1), running variances
    0.5 + U(0, 1). numpy only, so that the card's machine draws the same."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(int(v) for v in shapes[key])
        leaf = key.split("/")[-1]
        if leaf == "kernel":
            bound = kernel_gain / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif leaf == "mean":
            v = 0.1 * rng.randn(*shape)
        elif leaf == "var":
            v = 0.5 + rng.rand(*shape)
        else:
            raise ValueError(f"no draw rule for {key}")
        out[key] = v.astype(np.float32)
    return out


def with_identity_stats(variables):
    """``variables`` with every BatchNorm running mean 0 and variance 1,
    the statistics of a fresh net."""
    out = dict(variables)
    for k, v in variables.items():
        if k.startswith("batch_stats/"):
            out[k] = (np.zeros_like(v) if k.endswith("/mean")
                      else np.ones_like(v))
    return out


def config_b_data():
    """Bench config B's data (`bench.py:341-343`)."""
    rng = np.random.RandomState(0)
    Xb = rng.rand(512, 64, 64).astype(np.float32)
    yb = rng.rand(512, 16).astype(np.float32)
    return Xb, yb


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


def make_seg_train_fixture():
    """Five cycles of the JAX Segmentor at config A's width from the Unet
    fixture's variables, on the CPU in float32."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import Segmentor
    from atomai_tpu.utils import make_lattice_stack

    imgs, masks, _ = make_lattice_stack(n_images=10, size=64, spacing=12,
                                        seed=0)
    base = dict(np.load(FIXTURE))
    m = Segmentor("Unet", 1, nb_filters=16, layers=(1, 2, 2, 3))
    m.params = unflatten(base, "params")
    m.batch_stats = unflatten(base, "batch_stats")
    with tempfile.TemporaryDirectory() as tmp, \
            jax.default_matmul_precision("highest"):
        m.fit(imgs[:8], masks[:8], imgs[8:], masks[8:],
              training_cycles=SEG_CYCLES, batch_size=SEG_BATCH,
              print_loss=SEG_CYCLES, filename=os.path.join(tmp, "seg"),
              mesh=False)
    out = {"x_train": imgs[:8].astype(np.float32),
           "y_train": masks[:8].astype(np.uint8),
           "x_test": imgs[8:].astype(np.float32),
           "y_test": masks[8:].astype(np.uint8),
           "schedule": np.asarray(m.batch_idx_train, np.int64),
           "train_loss": np.asarray(m.loss_acc["train_loss"], np.float32),
           "test_loss": np.asarray(m.loss_acc["test_loss"], np.float32)}
    params = jax.tree.map(np.asarray, jax.device_get(m.params))
    stats = jax.tree.map(np.asarray, jax.device_get(m.batch_stats))
    for name in ("ConvBlock_0", "Conv_0"):
        out.update(flatten({name: params[name]}, "final/params"))
        if name in stats:
            out.update(flatten({name: stats[name]}, "final/batch_stats"))
    return out


def make_imspec_fixture():
    """Three cycles of the JAX ImSpec at config B's width from seeded
    variables, on the CPU in float32."""
    import tempfile

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import ImSpec

    Xb, yb = config_b_data()
    m = ImSpec((64, 64), (16,), latent_dim=2)
    # shapes only: no initialiser runs
    init = jax.eval_shape(lambda x0: dict(m.net.init(
        {"params": jax.random.key(0)}, x0, False)), jnp.asarray(Xb[:1]))
    init = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), init)
    shapes = {k: np.asarray(v.shape, np.int64) for k, v in
              {**flatten(dict(init["params"]), "params"),
               **flatten(dict(init["batch_stats"]), "batch_stats")}.items()}
    variables = seeded_variables(shapes)
    m.params = unflatten(variables, "params")
    m.batch_stats = unflatten(variables, "batch_stats")
    with tempfile.TemporaryDirectory() as tmp, \
            jax.default_matmul_precision("highest"):
        m.fit(Xb, yb, Xb[:64], yb[:64], training_cycles=IMSPEC_CYCLES,
              batch_size=IMSPEC_BATCH, print_loss=IMSPEC_CYCLES,
              filename=os.path.join(tmp, "imspec"), mesh=False)
        pred = m.predict(Xb[:IMSPEC_PREDICT], verbose=False)
    out = {f"shape/{k}": v for k, v in shapes.items()}
    out.update({
        "schedule": np.asarray(m.batch_idx_train, np.int64),
        "train_loss": np.asarray(m.loss_acc["train_loss"], np.float32),
        "test_loss": np.asarray(m.loss_acc["test_loss"], np.float32),
        "predict": np.asarray(pred, np.float32)})
    params = jax.tree.map(np.asarray, jax.device_get(m.params))
    stats = jax.tree.map(np.asarray, jax.device_get(m.batch_stats))
    for part, name in IMSPEC_FINAL:
        out.update(flatten({part: {name: params[part][name]}},
                           "final/params"))
        if name in stats[part]:
            out.update(flatten({part: {name: stats[part][name]}},
                               "final/batch_stats"))
    return out


def ensemble_data():
    """12 frames of 32x32 and their masks, the first 10 to train."""
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(n_images=12, size=32, spacing=8,
                                        seed=2)
    return (imgs[:10].astype(np.float32), masks[:10].astype(np.uint8),
            imgs[10:].astype(np.float32), masks[10:].astype(np.uint8))


LAYOUT = "vmap"


def run_jax_ensemble_from_baseline(swa=False):
    """(base params, trainer) of the JAX ensemble run of the fixture."""
    import tempfile

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.trainers import EnsembleTrainer

    x, y, xt, yt = ensemble_data()
    et = EnsembleTrainer("Unet", 1, nb_filters=ENSEMBLE["nb_filters"],
                         layers=ENSEMBLE["layers"])
    # one jitted init (an eager flax init compiles every initialiser
    # separately); preset, so that the trainer does not draw its own
    v = jax.device_get(jax.jit(lambda k, x0: dict(et.net.init(
        {"params": k, "dropout": k}, x0, False)))(
            jax.random.key(3), jnp.asarray(x[:1, ..., None])))
    base = jax.tree.map(np.asarray, dict(v["params"]))
    et.params, et.batch_stats = base, dict(v["batch_stats"])
    with tempfile.TemporaryDirectory() as tmp, \
            jax.default_matmul_precision("highest"):
        et.compile_ensemble_trainer(
            batch_size=ENSEMBLE["batch"], swa=swa, mesh=False,
            member_layout=LAYOUT, filename=os.path.join(tmp, "ens"))
        et.train_ensemble_from_baseline(
            x, y, xt, yt, basemodel=base, n_models=ENSEMBLE["n_models"],
            training_cycles_ensemble=ENSEMBLE["cycles"])
    return base, et


def make_ensemble_fixture():
    """Two members fine-tuned for three cycles from one baseline by the
    JAX EnsembleTrainer, on the CPU in float32."""
    import jax
    from atomai_tpu.trainers.trainer import _shuffled_batch_schedule
    x, y, xt, yt = ensemble_data()
    base, et = run_jax_ensemble_from_baseline()
    nb = len(x) // ENSEMBLE["batch"]
    out = {"x_train": x, "y_train": y, "x_test": xt, "y_test": yt,
           "schedules": np.stack([
               _shuffled_batch_schedule(nb, ENSEMBLE["cycles"], i + 2)
               for i in range(ENSEMBLE["n_models"])]).astype(np.int64),
           "train_loss": np.asarray(et.loss_acc["train_loss"], np.float32)}
    out.update(flatten(base, "base"))
    for i, member in et.ensemble_state_dict.items():
        out.update(flatten(jax.tree.map(np.asarray, member),
                           f"member/{i}"))
    return out


def dkl_fixture_data():
    """(X (512, 64), y (512,), X_predict (256, 64)): config E's kind of
    data (`bench.py:410-411`), numpy seed 1."""
    rng = np.random.RandomState(1)
    X = rng.randn(DKL["n"], DKL["indim"]).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.randn(DKL["n"])).astype(np.float32)
    Xp = rng.randn(DKL["n_predict"], DKL["indim"]).astype(np.float32)
    return X, y, Xp


def dkl_fe_params(seed=0):
    """The full-width extractor's flax params (``Dense_i`` kernels
    (in, out) and biases), drawn by :func:`seeded_variables`."""
    dims = [DKL["indim"], *DKL["hidden"], DKL["embedim"]]
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"params/Dense_{i}/kernel"] = (a, b)
        shapes[f"params/Dense_{i}/bias"] = (b,)
    return unflatten(seeded_variables(shapes, seed), "params")


def dkl_gp_init():
    """The JAX ``dklGPTrainer``'s initial raw GP parameters for one
    output (``init_gp_params(2, (1,))``): zeros."""
    e = DKL["embedim"]
    return {"raw_lengthscale": np.zeros((1, e), np.float32),
            "raw_outputscale": np.zeros(1, np.float32),
            "raw_noise": np.zeros(1, np.float32),
            "mean_const": np.zeros(1, np.float32)}


def gp2d_data():
    """(X (400, 2), y, X_predict (50, 2)) of a smooth 2D function, numpy
    seed 2."""
    rng = np.random.RandomState(2)
    X = rng.uniform(-2, 2, (GP2D["n"], 2)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) * np.cos(X[:, 1])
         + 0.05 * rng.randn(GP2D["n"])).astype(np.float32)
    Xp = rng.uniform(-2, 2, (GP2D["n_predict"], 2)).astype(np.float32)
    return X, y, Xp


def reconstruct_image():
    """A 32 x 32 sin-cos image with about half its pixels measured (the
    others 0), numpy seed 3."""
    n = RECONSTRUCT["size"]
    yy, xx = np.mgrid[:n, :n]
    true = np.sin(yy / 5.0) * np.cos(xx / 5.0)
    mask = np.random.RandomState(3).rand(n, n) > 0.5
    return np.where(mask, true, 0.0).astype(np.float32)


def make_dklgp_fixture():
    """The three GP runs of the JAX package on the CPU in float32."""
    import contextlib
    import io

    import jax
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import Reconstructor, dklGPR
    from atomai_tpu.trainers import GPTrainer

    X, y, Xp = dkl_fixture_data()
    out = {}
    with jax.default_matmul_precision("highest"), \
            contextlib.redirect_stdout(io.StringIO()):
        m = dklGPR(DKL["indim"], embedim=DKL["embedim"])
        m.compile_trainer(X, y, training_cycles=DKL["cycles"], lr=DKL["lr"])
        m.fe_params = dkl_fe_params()
        m.gp_params = dkl_gp_init()
        m._train_params = {"gp": m.gp_params, "fe": m.fe_params}
        m.opt_state = m.tx.init(m._train_params)
        m.fit(X, y, DKL["cycles"], print_loss=DKL["cycles"])
        mean, var = m.predict(Xp)
        out.update({"dkl_loss": np.asarray(m.train_loss, np.float32),
                    "dkl_mean": mean, "dkl_var": var,
                    "dkl_embed": m.embed(Xp)})
        out.update(flatten(jax.device_get(dict(m.gp_params)), "dkl_gp"))
        X2, y2, Xp2 = gp2d_data()
        for kind, kw in (("exact", {}), ("kissgp", {
                "grid_points_ratio": GP2D["grid_points_ratio"]})):
            t = GPTrainer()
            t.run(X2, y2, GP2D["cycles"], print_loss=GP2D["cycles"],
                  kernel_type=kind, **kw)
            mean, var = t.predict(Xp2)
            out.update({f"gp_{kind}_loss": np.asarray(t.train_loss),
                        f"gp_{kind}_mean": mean, f"gp_{kind}_var": var})
        out["reconstruct"] = Reconstructor().reconstruct(
            reconstruct_image(), training_cycles=RECONSTRUCT["cycles"],
            print_loss=RECONSTRUCT["cycles"])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def zoo_jax_net(name):
    """The JAX net of :data:`ZOO_NETS` entry ``name``."""
    kind, kw = ZOO_NETS[name]
    if kind == "seg":
        from atomai_tpu.nets import init_fcnn_model
        kw = dict(kw)
        return init_fcnn_model(kw.pop("model"), 1, **kw)[0]
    if kind == "denoiser":
        from atomai_tpu.models.denoiser import DenoiserNet
        return DenoiserNet()
    from atomai_tpu.nets import init_cls_model, init_reg_model
    if kind == "reg":
        return init_reg_model(1, kw["backbone"])[0]
    return init_cls_model(kw["nb_classes"], kw["backbone"])[0]


def zoo_reg_data():
    """40 images of 64 x 64 (numpy seed 1), each a noisy ramp whose slope
    is the target."""
    rng = np.random.RandomState(1)
    n, size = ZOO_REG["n"], ZOO_REG["size"]
    slope = rng.rand(n).astype(np.float32)
    ramp = np.linspace(0, 1, size, dtype=np.float32)[None, None, :]
    X = slope[:, None, None] * ramp + 0.1 * rng.rand(n, size, size)
    return X.astype(np.float32), slope


def variable_shapes(net, x):
    """{"params/...": shape, "batch_stats/...": shape} of ``net``, from
    ``jax.eval_shape`` (no initialiser runs)."""
    import jax
    import jax.numpy as jnp
    init = jax.eval_shape(lambda x0: dict(net.init(
        {"params": jax.random.key(0)}, x0, False)), jnp.asarray(x))
    out = {}
    for col in ("params", "batch_stats"):
        if col in init:
            zeros = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                                 dict(init[col]))
            out.update({k: np.asarray(v.shape, np.int64) for k, v in
                        flatten(zeros, col).items()})
    return out


def make_zoo_fixture():
    """Eval forwards of every zoo net and three SGD cycles of
    Regressor("mobilenet"), from seeded variables, on the CPU in
    float32."""
    import tempfile

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import Regressor

    x = np.random.RandomState(0).rand(2, 64, 64, 1).astype(np.float32)
    out = {"x": x}
    with jax.default_matmul_precision("highest"):
        for name in ZOO_NETS:
            net = zoo_jax_net(name)
            shapes = variable_shapes(net, x)
            v = seeded_variables(shapes, kernel_gain=ZOO_GAIN)
            variables = {col: unflatten(v, col) for col in
                         ("params", "batch_stats") if any(
                             k.startswith(col + "/") for k in v)}
            out[f"y/{name}"] = np.asarray(jax.jit(
                lambda v, x0: net.apply(v, x0, False))(
                    variables, jnp.asarray(x)), np.float32)
            out.update({f"shape/{name}/{k}": s for k, s in shapes.items()})
        X, y = zoo_reg_data()
        t = ZOO_REG["n_test"]
        m = Regressor("mobilenet", 1)
        v = with_identity_stats(seeded_variables(
            {k[len("shape/reg_mobilenet/"):]: s for k, s in out.items()
             if k.startswith("shape/reg_mobilenet/")}, kernel_gain=ZOO_GAIN))
        m.params = unflatten(v, "params")
        m.batch_stats = unflatten(v, "batch_stats")
        with tempfile.TemporaryDirectory() as tmp:
            m.fit(X[:-t], y[:-t], X[-t:], y[-t:],
                  training_cycles=ZOO_REG["cycles"],
                  batch_size=ZOO_REG["batch"], print_loss=ZOO_REG["cycles"],
                  optimizer="sgd", lr_scheduler=[ZOO_REG["lr"]],
                  filename=os.path.join(tmp, "reg"), mesh=False)
    out.update({
        "reg_schedule": np.asarray(m.batch_idx_train, np.int64),
        "reg_train_loss": np.asarray(m.loss_acc["train_loss"], np.float32),
        "reg_test_loss": np.asarray(m.loss_acc["test_loss"], np.float32)})
    params = jax.tree.map(np.asarray, jax.device_get(m.params))
    stats = jax.tree.map(np.asarray, jax.device_get(m.batch_stats))
    for path in ZOO_REG_FINAL:
        for col, tree in (("params", params), ("batch_stats", stats)):
            node = tree
            for part in path:
                node = node.get(part, {}) if isinstance(node, dict) else {}
            if node:
                out.update(flatten({"/".join(path): node},
                                   f"reg_final/{col}"))
    return out


def jvae_batch():
    """The 128 config C patches of the rVAE fixture."""
    return config_c_patches()[::8][:RVAE_BATCH].astype(np.float32)


def jvae_noise(model):
    """(eps, u) of a joint model at config C's width: the continuous
    latents' normal noise and the 4-way discrete latent's uniforms."""
    rng = np.random.RandomState(0)
    cont = 5 if model == "jrvae" else 2
    return (rng.randn(RVAE_BATCH, cont).astype(np.float32),
            rng.rand(RVAE_BATCH, 4).astype(np.float32))


def make_jvae_fixture():
    """One jVAE and one jrVAE training step at config C's width from
    seeded params, computed with the JAX package on the CPU in float32."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import optax
    jax.config.update("jax_platforms", "cpu")
    import atomai_tpu as aoi

    x = jnp.asarray(jvae_batch())
    out = {}
    for name, cls in JVAE_MODELS.items():
        m = getattr(aoi.models, cls)((32, 32), latent_dim=2,
                                     discrete_dim=[4])
        m.dx_prior = 0.1
        m.kdict_["phi_prior"] = 0.1
        m._init_params()
        shapes = {k: np.asarray(v.shape, np.int64) for k, v in flatten(
            jax.tree.map(np.asarray, m.params), "params").items()}
        params = unflatten(seeded_variables(shapes, JVAE_SEEDS[name]),
                           "params")
        eps, u = jvae_noise(name)
        # the noise comes from the fixture, not from JAX keys
        m.reparameterize = lambda key, mu, sd: mu + sd * jnp.asarray(eps)

        def discrete(key, alpha, tau, u=jnp.asarray(u), cls=type(m)):
            with mock.patch.object(jax.random, "uniform",
                                   lambda *a, **k: u):
                return cls.reparameterize_discrete(key, alpha, tau)

        m.reparameterize_discrete = discrete

        def elbo_fn(p, m=m):
            return m.forward_compute_elbo_fn(p, x, None, jax.random.key(0),
                                             JVAE_NUM_ITER, True)

        with jax.default_matmul_precision("highest"):
            elbo, grads = jax.jit(jax.value_and_grad(elbo_fn))(params)
        tx = optax.adam(1e-4)
        updates, _ = tx.update(jax.tree.map(lambda g: -g, grads),
                               tx.init(params), params)
        stepped = optax.apply_updates(params, updates)
        out.update({f"shape/{name}/{k}": v for k, v in shapes.items()})
        out.update({f"{name}/eps": eps, f"{name}/u": u,
                    f"{name}/elbo": np.asarray(elbo, np.float32)})
        for prefix, tree in (("grads", grads), ("adam", stepped)):
            out.update(flatten(jax.tree.map(np.asarray, tree),
                               f"{name}_{prefix}"))
    return out


def make_aoi_fixture(unet_path=AOI_UNET, rvae_path=AOI_RVAE):
    """Writes the JAX package's own checkpoints of a config A Unet (with
    its optimizer state) and a config C rVAE to ``unet_path`` and
    ``rvae_path``, and returns the JAX numbers beside them; on the CPU in
    float32."""
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import Segmentor, rVAE
    from atomai_tpu.utils import make_lattice_stack

    imgs, masks, _ = make_lattice_stack(n_images=10, size=64, spacing=12,
                                        seed=0)
    base = dict(np.load(FIXTURE))
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            jax.default_matmul_precision("highest"):
        m = Segmentor("Unet", 1, nb_filters=16, layers=(1, 2, 2, 3))
        m.params = unflatten(base, "params")
        m.batch_stats = unflatten(base, "batch_stats")
        m.fit(imgs[:8], masks[:8], imgs[8:], masks[8:],
              training_cycles=SEG_CYCLES, batch_size=SEG_BATCH,
              print_loss=SEG_CYCLES, filename=os.path.join(tmp, "seg"),
              mesh=False)
        m.save_model(unet_path[:-len(".aoi")], include_optimizer=True)
        y = m.net.apply({"params": m.params, "batch_stats": m.batch_stats},
                        base["x"], False)
        out["unet/y"] = np.asarray(y, np.float32)
        m.resume_training(unet_path, additional_cycles=AOI_RESUME_CYCLES)
        out["unet/resume_schedule"] = np.asarray(m.batch_idx_train,
                                                 np.int64)
        for k in ("train_loss", "test_loss"):
            out[f"unet/resume_{k}"] = np.asarray(
                m.loss_acc[k][-AOI_RESUME_CYCLES:], np.float32)

        X = config_c_patches()
        v = rVAE((32, 32), latent_dim=2)
        v.fit(X, training_cycles=AOI_RVAE_EPOCHS, batch_size=AOI_RVAE_BATCH,
              filename=os.path.join(tmp, "rvae"))
        v.save_model(rvae_path[:-len(".aoi")])
        out["rvae/x"] = X[:16].astype(np.float32)
        out["rvae/z_mean"], out["rvae/z_logsd"] = (
            np.asarray(a, np.float32) for a in v.encode(X[:16]))
        g = np.linspace(-1.5, 1.5, 3, dtype=np.float32)
        out["rvae/z"] = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
        out["rvae/decoded"] = np.asarray(v.decode(out["rvae/z"]),
                                         np.float32)
        out["rvae/manifold"] = np.asarray(v.manifold2d(d=4), np.float32)
    return out


def main():
    for path, make in ((FIXTURE, make_fixture),
                       (RVAE_FIXTURE, make_rvae_fixture),
                       (SEG_TRAIN_FIXTURE, make_seg_train_fixture),
                       (IMSPEC_FIXTURE, make_imspec_fixture),
                       (ENSEMBLE_FIXTURE, make_ensemble_fixture),
                       (DKLGP_FIXTURE, make_dklgp_fixture),
                       (ZOO_FIXTURE, make_zoo_fixture),
                       (JVAE_FIXTURE, make_jvae_fixture),
                       (AOI_FIXTURE, make_aoi_fixture)):
        arrays = make()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **arrays)
        n_bytes = sum(a.nbytes for a in arrays.values())
        print(f"wrote {path}: {len(arrays)} arrays, {n_bytes} bytes")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
