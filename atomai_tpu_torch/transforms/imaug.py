"""Data augmentation on the device, vectorised over the batch.

Counterpart of `atomai_tpu/transforms/imaug.py:34-345`, with the same ops,
parameter ranges and op order (custom -> rotation -> zoom -> resize ->
gauss -> jitter -> poisson -> salt & pepper -> blur -> contrast ->
background, each enabled op once). Each random op is split in two halves,
both batched over the images (the JAX package's ``vmap``):

- a *draw* ``draw(generator, images) -> params``: the op's random draws,
  exactly those of the JAX op (an index or an integer level per image,
  noise fields, Poisson samples), from a ``torch.Generator`` on the images'
  device;
- an *apply* ``apply(images, targets, params) -> (images, targets)``:
  deterministic given those draws.

The Poisson op's samples have the image itself as their rate, so its draw
reads the images it is given. Images are (N, H, W) floats, targets
channel-last one-hot (N, H, W, C) floats during the geometric ops, as in
the JAX package. The whole pipeline runs in float32 with TF32 off: label
masks are warped and rounded back to integers, and a TF32 product could
flip a pixel near 0.5.

Deviations, as in the JAX package: ``resize`` is a scale jitter that keeps
the frame's size, and the interpolation is bilinear.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import Precision
from .warp import separable_sample, separable_sample_nhwc

Params = Dict[str, torch.Tensor]


def _minmax(x: torch.Tensor) -> torch.Tensor:
    """Min-max normalisation over the whole batch."""
    lo = x.min()
    return (x - lo) / torch.clamp(x.max() - lo, min=1e-12)


def _randint(g: torch.Generator, lo: int, hi: int, n: int,
             device: torch.device) -> torch.Tensor:
    """n integers uniform in [lo, hi); ``lo`` alone when hi <= lo, as
    ``jax.random.randint``."""
    return torch.randint(int(lo), max(int(hi), int(lo) + 1), (n,),
                         generator=g, device=device)


def _bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-image (N,) parameter shaped to broadcast against ``x``."""
    return p.reshape(p.shape + (1,) * (x.ndim - p.ndim))


# --------------------------------------------------------------------
# ops: draw(generator, images, **config) and apply(images, targets, p,
# **config). The parameters are the raw draws of the JAX op (indices,
# integer levels, noise fields); the apply half derives the rest.
# --------------------------------------------------------------------

def _draw_rotation(g, imgs) -> Params:
    """flip type in {-1, 0, 1, 2}: both axes, vertical, horizontal, or 90
    degrees counter-clockwise (square frames only)."""
    return {"flip": _randint(g, -1, 3, len(imgs), imgs.device)}


def _apply_rotation(imgs, gts, p: Params):
    def pick(a):
        both, vert, horiz = a.flip(1, 2), a.flip(1), a.flip(2)
        rot = torch.rot90(a, 1, dims=(1, 2)) if a.shape[1] == a.shape[2] \
            else a
        f = _bcast(p["flip"], a)
        return torch.where(f == -1, both, torch.where(
            f == 0, vert, torch.where(f == 1, horiz, rot)))
    return pick(imgs), pick(gts)


def _draw_index(g, imgs, values: np.ndarray) -> Params:
    return {"index": _randint(g, 0, len(values), len(imgs), imgs.device)}


def zoom_grid(imgs, p: Params, values: np.ndarray):
    """The sample rows and columns (N, S) of a centre crop of side
    ``values[index]`` resampled to the frame's short side S."""
    h, w = imgs.shape[1:3]
    S = min(h, w)
    zv = torch.as_tensor(values, device=imgs.device)[p["index"]]
    scale = (zv.float() / S)[:, None]
    rr = torch.arange(S, dtype=torch.float32, device=imgs.device)[None]
    return ((h // 2 - zv // 2).float()[:, None] + rr * scale,
            (w // 2 - zv // 2).float()[:, None] + rr * scale)


def resize_grid(imgs, p: Params, values: np.ndarray):
    """The sample rows (N, H) and columns (N, W) of a scale jitter by
    ``values[index]`` about the frame's centre, on the original canvas."""
    h, w = imgs.shape[1:3]
    f = torch.as_tensor(np.asarray(values, np.float32),
                        device=imgs.device)[p["index"]][:, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ar = partial(torch.arange, dtype=torch.float32, device=imgs.device)
    return (ar(h)[None] - cy) / f + cy, (ar(w)[None] - cx) / f + cx


def _apply_zoom(imgs, gts, p: Params, values: np.ndarray):
    ys, xs = zoom_grid(imgs, p, values)
    return (torch.clamp(separable_sample(imgs, ys, xs), 0, 1),
            torch.round(separable_sample_nhwc(gts, ys, xs)))


def _apply_resize(imgs, gts, p: Params, values: np.ndarray):
    ys, xs = resize_grid(imgs, p, values)
    return (separable_sample(imgs, ys, xs),
            torch.round(separable_sample_nhwc(gts, ys, xs)))


def _draw_level(g, imgs, rng) -> Params:
    """One integer level a image, uniform in [rng[0], rng[1])."""
    return {"level": _randint(g, rng[0], rng[1], len(imgs), imgs.device)}


def _draw_gauss(g, imgs, rng) -> Params:
    return {**_draw_level(g, imgs, rng),
            "noise": torch.randn(imgs.shape, generator=g,
                                 device=imgs.device)}


def _apply_gauss(imgs, gts, p: Params):
    """Additive Gaussian noise of variance level * 1e-4, clipped."""
    sigma = torch.sqrt(1e-4 * p["level"].float())
    return torch.clamp(imgs + _bcast(sigma, imgs) * p["noise"], 0.0,
                       1.0), gts


def _draw_jitter(g, imgs, rng) -> Params:
    n, h = imgs.shape[:2]
    lam = _draw_level(g, imgs, rng)["level"].float() / 10.0
    return {"shifts": torch.poisson(lam[:, None].expand(n, h).contiguous(),
                                    generator=g).long()}


def _apply_jitter(imgs, gts, p: Params):
    """Each row shifted right (cyclically) by its Poisson draw."""
    w = imgs.shape[2]
    cols = torch.arange(w, device=imgs.device)
    idx = (cols[None, None] - p["shifts"][..., None]) % w
    return torch.gather(imgs, 2, idx), gts


def _poisson_scale(imgs: torch.Tensor, level: torch.Tensor
                   ) -> torch.Tensor:
    """(50 / level) ** ceil(log2(number of distinct values)) a image."""
    s = torch.sort(imgs.reshape(len(imgs), -1), dim=1).values
    unique = 1 + (torch.abs(torch.diff(s, dim=1)) > 0).sum(1)
    return (50.0 / level.float()) ** torch.ceil(torch.log2(unique.float()))


def _draw_poisson(g, imgs, rng) -> Params:
    """Shot-noise counts: Poisson with the scaled image as the rate."""
    p = _draw_level(g, imgs, rng)
    vals = _poisson_scale(imgs, p["level"])
    p["counts"] = torch.poisson(
        torch.clamp(imgs, min=0.0) * _bcast(vals, imgs), generator=g)
    return p


def _apply_poisson(imgs, gts, p: Params):
    vals = _poisson_scale(imgs, p["level"])
    return p["counts"] / _bcast(vals, imgs), gts


def _draw_sp(g, imgs, rng) -> Params:
    return {**_draw_level(g, imgs, rng),
            "u": torch.rand(imgs.shape, generator=g, device=imgs.device)}


def _apply_sp(imgs, gts, p: Params):
    """Salt (1) where u < amount / 2, pepper (0) where amount / 2 <= u <
    amount, amount = level * 1e-3."""
    a, u = _bcast(p["level"].float() * 1e-3, imgs), p["u"]
    out = torch.where(u < a / 2, torch.ones_like(imgs), imgs)
    return torch.where((u >= a / 2) & (u < a), torch.zeros_like(out),
                       out), gts


def _apply_blur(imgs, gts, p: Params):
    """Separable Gaussian blur of sigma level * 5e-2 with a fixed 21-tap
    support and reflected edges; each image its own sigma (a grouped
    convolution)."""
    n = len(imgs)
    radius = 10
    sigma = p["level"].float() * 5e-2
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=imgs.device)
    k = torch.exp(-0.5 * (x[None] / torch.clamp(sigma, min=1e-6)[
        :, None]) ** 2)
    k = k / k.sum(1, keepdim=True)
    y = F.pad(imgs[None], (0, 0, radius, radius), mode="reflect")
    y = F.conv2d(y, k[:, None, :, None], groups=n)
    y = F.pad(y, (radius, radius, 0, 0), mode="reflect")
    y = F.conv2d(y, k[:, None, None, :], groups=n)
    return y[0], gts


def _apply_contrast(imgs, gts, p: Params):
    """Gamma adjustment, gamma = level / 10."""
    gamma = p["level"].float() / 10.0
    return torch.clamp(imgs, min=0.0) ** _bcast(gamma, imgs), gts


def _draw_background(g, imgs) -> Params:
    n, h, w = imgs.shape
    m = min(h, w)

    def ri(lo, hi, size=n):
        return _randint(g, lo, hi, size, imgs.device)
    return {"x0": ri(0, h - h // 4), "y0": ri(0, w - w // 4),
            "ab": ri(10, 20, 2 * n).reshape(n, 2),
            "fwhm": ri(m // 4, m - m // 2), "amp": ri(-10, 10)}


def _apply_background(imgs, gts, p: Params):
    """Adds an asymmetric 2D Gaussian illumination."""
    h, w = imgs.shape[1:3]
    x, y = torch.meshgrid(
        torch.linspace(0, h, h, device=imgs.device),
        torch.linspace(0, w, w, device=imgs.device), indexing="ij")

    def per(v):
        return _bcast(v.float(), imgs)
    ab = p["ab"].float() / 10.0
    Z = torch.exp(-math.log(2.0) * (per(ab[:, 0]) * (x - per(p["x0"])) ** 2
                                    + per(ab[:, 1]) * (y - per(p["y0"])) ** 2)
                  / per(p["fwhm"]) ** 2)
    return imgs + 0.05 * per(p["amp"]) * Z, gts


Op = Tuple[str, Callable[..., Params], Callable]


@dataclasses.dataclass(frozen=True)
class DataTransform:
    """Augmentation pipeline (the JAX package's ``DataTransform``): static
    config, applied with ``.run(generator, images, targets)``."""
    n_channels: Optional[int] = None
    rotation: bool = False
    zoom: Union[bool, int] = False
    resize: Union[bool, Tuple[float, float]] = False
    gauss_noise: Union[bool, Tuple[float, float]] = False
    jitter: Union[bool, Tuple[float, float]] = False
    poisson_noise: Union[bool, Tuple[float, float]] = False
    salt_and_pepper: Union[bool, Tuple[float, float]] = False
    blur: Union[bool, Tuple[float, float]] = False
    contrast: Union[bool, Tuple[float, float]] = False
    background: bool = False
    custom_transform: Optional[Callable] = None

    @staticmethod
    def _range(v, default):
        return default if v is True else tuple(v)

    def ops(self, shape: Tuple[int, ...], same_dim: bool = True
            ) -> List[Op]:
        """(name, draw, apply) of each enabled op, in the pipeline's order,
        for images of ``shape`` (N, H, W); the geometric ops only when the
        targets are (N, H, W, C) masks (``same_dim``)."""
        h, w = shape[1:3]
        ops: List[Op] = []
        if self.rotation and same_dim:
            ops.append(("rotation", _draw_rotation, _apply_rotation))
        if self.zoom and same_dim:
            zoom = 2 if self.zoom is True else int(self.zoom)
            s = min(h, w)
            values = np.arange(int(s // zoom), s + 8, 8)
            values = values[values <= s]
            ops.append(("zoom", partial(_draw_index, values=values),
                        partial(_apply_zoom, values=values)))
        if self.resize and same_dim:
            rs = (2, 1.5) if self.resize is True else tuple(self.resize)
            values = np.linspace(1.0 / rs[0], rs[1], 9)
            ops.append(("resize", partial(_draw_index, values=values),
                        partial(_apply_resize, values=values)))
        for name, draw, apply, default in (
                ("gauss_noise", _draw_gauss, _apply_gauss, (0, 50)),
                ("jitter", _draw_jitter, _apply_jitter, (0, 50)),
                ("poisson_noise", _draw_poisson, _apply_poisson, (30, 40)),
                ("salt_and_pepper", _draw_sp, _apply_sp, (0, 50)),
                ("blur", _draw_level, _apply_blur, (1, 50)),
                ("contrast", _draw_level, _apply_contrast, (5, 20))):
            v = getattr(self, name)
            if v:
                ops.append((name, partial(draw, rng=self._range(v, default)),
                            apply))
        if self.background:
            ops.append(("background", _draw_background, _apply_background))
        return ops

    def run(self, generator: torch.Generator, images: torch.Tensor,
            targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (N, H, W), targets (N, H, W, C) -> the augmented pair."""
        with Precision.full().scope(images.device):
            same_dim = targets.ndim == 4
            images = _minmax(images)
            if self.custom_transform is not None:
                images, targets = self.custom_transform(images, targets)
            for _, draw, apply in self.ops(images.shape, same_dim):
                images, targets = apply(images, targets,
                                        draw(generator, images))
            return _minmax(images), targets


# the original atomai name
datatransform = DataTransform


def squeeze_channels(labels_onehot: torch.Tensor) -> torch.Tensor:
    """One-hot (N, H, W, C) -> class masks (N, H, W), clipped to the
    classes."""
    if labels_onehot.shape[-1] == 1:
        return labels_onehot[..., 0]
    c = labels_onehot.shape[-1]
    weights = torch.arange(c, dtype=labels_onehot.dtype,
                           device=labels_onehot.device)
    return torch.clamp((labels_onehot * weights).sum(-1), 0, c - 1)


def unsqueeze_channels(labels: torch.Tensor, n_channels: int
                       ) -> torch.Tensor:
    """Class masks -> channel-last one-hot float masks."""
    if n_channels == 1:
        return labels[..., None] if labels.ndim == 3 else labels
    return F.one_hot(labels.long(), n_channels).float()


_AUG_KEYS_SEG = ["custom_transform", "zoom", "gauss_noise", "jitter",
                 "poisson_noise", "contrast", "salt_and_pepper", "blur",
                 "resize", "rotation", "background"]


def seg_augmentor(nb_classes: int, **kwargs: Any) -> Optional[Callable]:
    """``augment_fn(generator, images NHWC, labels (N, H, W))`` for
    segmentation training, or None when no augmentation kwarg is given."""
    augdict = {k: kwargs[k] for k in _AUG_KEYS_SEG if k in kwargs}
    if not augdict:
        return None
    dt = DataTransform(nb_classes, **augdict)

    def augmentor(generator, images, labels):
        imgs = images[..., 0] if images.ndim == 4 else images
        imgs, gts = dt.run(generator, imgs,
                           unsqueeze_channels(labels, nb_classes))
        return imgs[..., None], squeeze_channels(gts).to(labels.dtype)

    return augmentor
