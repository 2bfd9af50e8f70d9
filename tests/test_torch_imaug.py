"""The port's warps and augmentation against the JAX package's.

- Warps: the same explicit coordinates through both packages, 1e-5
  (float32 interpolation sums in another order).
- Each augmentation op's apply half: the port draws the op's parameters,
  and the JAX op runs on each image with exactly those draws fed to it in
  place of its own ``jax.random`` calls (monkeypatched for the call). Images
  agree to 1e-5 (float32; the warps' and the blur's sums run in another
  order); label masks exactly.
- Each op's draw half: over 2,000 images, every draw inside the JAX op's
  range and its mean within 4 standard errors of the distribution's.
- The invariants of `tests/transforms/test_imaug.py`: noise ops leave the
  labels as they are, affine ops move them with the images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu.transforms import imaug as jimaug
from atomai_tpu.transforms import warp as jwarp
from atomai_tpu_torch.transforms import (DataTransform, seg_augmentor,
                                         squeeze_channels,
                                         unsqueeze_channels)
from atomai_tpu_torch.transforms import warp as twarp

torch.set_num_threads(1)

ATOL = 1e-5
ALL_OPS = dict(rotation=True, zoom=True, resize=True, gauss_noise=True,
               jitter=True, poisson_noise=True, salt_and_pepper=True,
               blur=True, contrast=True, background=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ warps

def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(37, 41).astype(np.float32)
    ys = rng.uniform(-2, 39, (23, 29)).astype(np.float32)
    xs = rng.uniform(-2, 43, (23, 29)).astype(np.float32)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                            jnp.asarray(ys), jnp.asarray(xs)))
    got = twarp.bilinear_sample(_t(img), _t(ys), _t(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_interp_matrix_matches_jax():
    coords = np.asarray([-1.5, -1.0, -0.25, 0.0, 3.5, 6.0, 6.5, 7.2],
                        np.float32)
    want = np.asarray(jwarp.interp_matrix(jnp.asarray(coords), 7))
    got = twarp.interp_matrix(_t(coords), 7).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_separable_samples_match_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(3, 16, 18).astype(np.float32)
    stack = rng.rand(3, 16, 18, 2).astype(np.float32)
    ys = np.sort(rng.uniform(-2, 17, (3, 11)), 1).astype(np.float32)
    xs = np.sort(rng.uniform(-2, 19, (3, 13)), 1).astype(np.float32)
    got = twarp.separable_sample(_t(img), _t(ys), _t(xs)).numpy()
    got_nhwc = twarp.separable_sample_nhwc(_t(stack), _t(ys), _t(xs)).numpy()
    assert got.shape == (3, 11, 13) and got_nhwc.shape == (3, 11, 13, 2)
    for i in range(3):
        args = (jnp.asarray(ys[i]), jnp.asarray(xs[i]))
        np.testing.assert_allclose(got[i], np.asarray(jwarp.separable_sample(
            jnp.asarray(img[i]), *args)), atol=ATOL)
        np.testing.assert_allclose(got_nhwc[i], np.asarray(
            jwarp.separable_sample_nhwc(jnp.asarray(stack[i]), *args)),
            atol=ATOL)


@pytest.mark.parametrize("shape", [(17, 17), (12, 15, 3)])
@pytest.mark.parametrize("angle", [0.3, np.pi / 2, -2.0])
def test_rotate_image_matches_jax(shape, angle):
    img = np.random.RandomState(2).rand(*shape).astype(np.float32)
    want = np.asarray(jwarp.rotate_image(jnp.asarray(img),
                                         jnp.float32(angle)))
    got = twarp.rotate_image(_t(img), angle).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# -------------------------------------------------------- op apply halves

# JAX op of each port op, and its draws in the order the JAX op makes them:
# (jax.random function, port parameter, per-image transform)
_JAX_OPS = {
    "rotation": (jimaug._apply_rotation, [("randint", "flip")]),
    "zoom": (jimaug._apply_zoom, [("randint", "index")]),
    "resize": (jimaug._apply_imresize, [("randint", "index")]),
    "gauss_noise": (jimaug._apply_gauss, [("randint", "level"),
                                          ("normal", "noise")]),
    "jitter": (jimaug._apply_jitter, [("randint", None),
                                      ("poisson", "shifts")]),
    "poisson_noise": (jimaug._apply_poisson, [("randint", "level"),
                                              ("poisson", "counts")]),
    "salt_and_pepper": (jimaug._apply_sp, [("randint", "level"),
                                           ("uniform", "u")]),
    "blur": (jimaug._apply_blur, [("randint", "level")]),
    "contrast": (jimaug._apply_contrast, [("randint", "level")]),
    "background": (jimaug._apply_background, [
        ("randint", "x0"), ("randint", "y0"), ("randint", "ab"),
        ("randint", "fwhm"), ("randint", "amp")]),
}


def _jax_op_with_draws(monkeypatch, name, i, params, img, gt, dt, shape):
    """The JAX op on image ``i``, its random draws replaced by the port's
    draws for that image."""
    fn, draws = _JAX_OPS[name]
    queue = {f: [] for f in ("randint", "normal", "uniform", "poisson")}
    for f, key in draws:
        queue[f].append(0 if key is None else params[key][i].numpy())

    def fake(f):
        def draw(*args, **kwargs):
            return jnp.asarray(queue[f].pop(0))
        return draw
    for f in queue:
        monkeypatch.setattr(jax.random, f, fake(f))
    h, w = shape[1:3]
    s = min(h, w)
    kw = {}
    if name == "zoom":
        v = np.arange(int(s // 2), s + 8, 8)
        kw["zoom_values"] = v[v <= s]
    elif name == "resize":
        kw["factors"] = np.linspace(1.0 / 2, 1.5, 9)
    elif name != "rotation" and name != "background":
        kw["rng"] = dt._range(getattr(dt, name), dict(
            gauss_noise=(0, 50), jitter=(0, 50), poisson_noise=(30, 40),
            salt_and_pepper=(0, 50), blur=(1, 50), contrast=(5, 20))[name])
    key = jax.random.key(0)
    if name in ("rotation", "zoom", "resize"):
        out = fn(key, jnp.asarray(img), jnp.asarray(gt), **kw)
    else:
        out = (fn(key, jnp.asarray(img), **kw), jnp.asarray(gt))
    monkeypatch.undo()
    assert all(not q for q in queue.values()), "unused draws"
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 24, 40)])
@pytest.mark.parametrize("name", list(ALL_OPS))
def test_op_apply_matches_jax(monkeypatch, name, shape):
    rng = np.random.RandomState(3)
    imgs = rng.rand(*shape).astype(np.float32)
    gts = (rng.rand(*shape, 1) > 0.5).astype(np.float32)
    dt = DataTransform(1, **{name: ALL_OPS[name]})
    ((op_name, draw, apply),) = dt.ops(shape)
    assert op_name == name
    g = torch.Generator().manual_seed(4)
    params = draw(g, _t(imgs))
    out_i, out_g = apply(_t(imgs), _t(gts), params)
    assert torch.isfinite(out_i).all()
    for i in range(shape[0]):
        want_i, want_g = _jax_op_with_draws(monkeypatch, name, i, params,
                                            imgs[i], gts[i], dt, shape)
        np.testing.assert_allclose(out_i[i].numpy(), want_i, atol=ATOL,
                                   err_msg=f"{name} image {i}")
        np.testing.assert_array_equal(out_g[i].numpy(), want_g,
                                      err_msg=f"{name} labels {i}")


# --------------------------------------------------------- op draw halves

def _uniform_int_stats(v, lo, hi):
    """Bounds, and the mean within 4 standard errors of U{lo..hi-1}'s."""
    v = v.double()
    assert int(v.min()) >= lo and int(v.max()) <= hi - 1
    mean = (lo + hi - 1) / 2
    se = np.sqrt(((hi - lo) ** 2 - 1) / 12 / v.numel())
    assert abs(float(v.mean()) - mean) < 4 * se + 1e-12


N_DRAWS = 2000


@pytest.mark.parametrize("name", list(ALL_OPS))
def test_op_draws_within_jax_ranges(name):
    shape = (N_DRAWS, 16, 16)
    imgs = torch.rand(shape, generator=torch.Generator().manual_seed(5))
    dt = DataTransform(1, **{name: ALL_OPS[name]})
    ((_, draw, _),) = dt.ops(shape)
    p = draw(torch.Generator().manual_seed(6), imgs)
    for v in p.values():
        assert len(v) == N_DRAWS
    ranges = dict(gauss_noise=(0, 50), salt_and_pepper=(0, 50),
                  blur=(1, 50), contrast=(5, 20), poisson_noise=(30, 40))
    if name == "rotation":
        _uniform_int_stats(p["flip"], -1, 3)
    elif name == "zoom":
        _uniform_int_stats(p["index"], 0, 2)    # values 8, 16 at 16 px
    elif name == "resize":
        _uniform_int_stats(p["index"], 0, 9)
    elif name == "jitter":
        # Poisson(level / 10), level ~ U{0..49}: mean 2.45
        s = p["shifts"].double()
        assert int(s.min()) >= 0
        se = float(s.mean(1).std()) / np.sqrt(N_DRAWS)
        assert abs(float(s.mean()) - 2.45) < 4 * se
    elif name == "background":
        _uniform_int_stats(p["x0"], 0, 12)
        _uniform_int_stats(p["y0"], 0, 12)
        _uniform_int_stats(p["ab"], 10, 20)
        _uniform_int_stats(p["fwhm"], 4, 8)
        _uniform_int_stats(p["amp"], -10, 10)
    else:
        _uniform_int_stats(p["level"], *ranges[name])
    if name == "gauss_noise":
        z = p["noise"].double()
        assert abs(float(z.mean())) < 4 / np.sqrt(z.numel())
        assert abs(float(z.std()) - 1) < 4 / np.sqrt(2 * z.numel())
    if name == "salt_and_pepper":
        u = p["u"].double()
        assert 0 <= float(u.min()) and float(u.max()) < 1
        assert abs(float(u.mean()) - 0.5) < 4 * np.sqrt(1 / 12 / u.numel())
    if name == "poisson_noise":
        # counts ~ Poisson(rate): their sum is within 4 sd of the rates'
        from atomai_tpu_torch.transforms.imaug import _poisson_scale
        rate = imgs * _poisson_scale(imgs, p["level"])[:, None, None]
        c = p["counts"].double()
        assert float(c.min()) >= 0 and bool((c == c.round()).all())
        total = float(rate.double().sum())
        assert abs(float(c.sum()) - total) < 4 * np.sqrt(total)


# ------------------------------------------------------------- invariants

@pytest.mark.parametrize("kw", [
    {"gauss_noise": True}, {"poisson_noise": True},
    {"salt_and_pepper": True}, {"contrast": True}, {"jitter": True},
    {"background": True}, {"blur": True}])
def test_noise_transforms_leave_labels_unchanged(kw):
    rng = np.random.RandomState(0)
    X = _t(rng.rand(5, 16, 16).astype(np.float32))
    y = _t(rng.randint(0, 2, (5, 16, 16, 1)).astype(np.float32))
    X_t, y_t = DataTransform(1, **kw).run(torch.Generator().manual_seed(1),
                                          X, y)
    assert torch.equal(y_t, y)
    assert not torch.equal(X_t, X)


@pytest.mark.parametrize("kw", [{"rotation": True}, {"zoom": True},
                                {"resize": (0.8, 1.2)}])
def test_affine_transforms_move_labels_with_images(kw):
    rng = np.random.RandomState(1)
    X = rng.rand(4, 32, 32).astype(np.float32)
    y = np.zeros((4, 32, 32, 1), np.float32)
    y[:, 4:12, 4:12, 0] = 1.0
    X_t, y_t = DataTransform(1, **kw).run(torch.Generator().manual_seed(3),
                                          _t(X), _t(y))
    assert not np.array_equal(y_t.numpy(), y), kw
    assert not np.array_equal(X_t.numpy(), X), kw


def test_pipeline_deterministic_and_shape_preserving():
    rng = np.random.RandomState(2)
    X = _t(rng.rand(4, 32, 32).astype(np.float32))
    y = _t((rng.rand(4, 32, 32, 1) > .5).astype(np.float32))
    dt = DataTransform(1, **ALL_OPS)
    a = dt.run(torch.Generator().manual_seed(42), X, y)
    b = dt.run(torch.Generator().manual_seed(42), X, y)
    c = dt.run(torch.Generator().manual_seed(43), X, y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == X.shape and a[1].shape == y.shape
    assert torch.isfinite(a[0]).all()
    assert float(a[0].min()) == 0.0 and float(a[0].max()) == 1.0


def test_seg_augmentor_binary_and_multiclass():
    g = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(4)
    imgs = _t(rng.rand(4, 32, 32, 1).astype(np.float32))
    labels = _t((rng.rand(4, 32, 32) > .5).astype(np.float32))
    X, y = seg_augmentor(1, rotation=True, zoom=True)(g, imgs, labels)
    assert X.shape == (4, 32, 32, 1) and y.shape == (4, 32, 32)
    assert y.dtype == torch.float32 and set(y.unique().tolist()) <= {0, 1}
    labels3 = _t(rng.randint(0, 3, (4, 32, 32)))
    X, y = seg_augmentor(3, rotation=True, zoom=True)(g, imgs, labels3)
    assert y.shape == (4, 32, 32) and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) <= 2


def test_seg_augmentor_none_when_no_kwargs():
    assert seg_augmentor(1) is None
    assert seg_augmentor(1, unrelated_kwarg=5) is None


def test_squeeze_unsqueeze_match_jax():
    labels = np.random.RandomState(5).randint(0, 4, (2, 16, 16))
    onehot = unsqueeze_channels(_t(labels), 4)
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jimaug.unsqueeze_channels(
            jnp.asarray(labels), 4)))
    np.testing.assert_array_equal(squeeze_channels(onehot).numpy(), labels)
    binary = _t(labels[..., None] > 1).float()
    assert torch.equal(squeeze_channels(binary), binary[..., 0])
