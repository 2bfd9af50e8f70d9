"""Image resizing, padding and random patches (counterpart of
`atomai_tpu/utils/img.py:28-39, 73-83, 241-251`)."""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def img_resize(image_data: np.ndarray, rs: Tuple[int, int],
               round_: bool = False) -> np.ndarray:
    """Resizes a stack (n, h, w[, c]) to ``rs`` bilinearly.

    ``jax.image.resize(..., "linear")`` widens its triangle kernel when it
    shrinks an image (antialiasing); ``antialias=True`` does the same here,
    and changes nothing when the image grows.
    """
    image_data = np.asarray(image_data)
    if image_data.shape[1:3] == tuple(rs):
        return image_data.copy()
    x = torch.from_numpy(np.asarray(image_data, np.float32))
    x = x.unsqueeze(1) if x.ndim == 3 else x.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(rs), mode="bilinear",
                      align_corners=False, antialias=True)
    y = y[:, 0] if image_data.ndim == 3 else y.permute(0, 2, 3, 1)
    out = y.numpy()
    return np.round(out) if round_ else out


def img_pad(image_data: np.ndarray, pooling: int) -> np.ndarray:
    """Zero-pads a stack (n, h, w[, c]) at the bottom and right so that h
    and w are divisible by ``pooling``."""
    _, h, w = image_data.shape[:3]
    ph = (-h) % pooling
    pw = (-w) % pooling
    if ph == 0 and pw == 0:
        return image_data
    pad_width = [(0, 0), (0, ph), (0, pw)] + \
        [(0, 0)] * (image_data.ndim - 3)
    return np.pad(image_data, pad_width, mode="constant")


def extract_patches_2d(image: np.ndarray, patch_size: Tuple[int, int],
                       max_patches: int, random_state: int = 0
                       ) -> np.ndarray:
    """``max_patches`` random (ph, pw) patches of a 2D image, drawn from
    ``np.random.RandomState(random_state)``: the JAX package's patches for
    the same arguments."""
    ph, pw = patch_size
    h, w = image.shape[:2]
    rng = np.random.RandomState(random_state)
    ii = rng.randint(0, h - ph + 1, max_patches)
    jj = rng.randint(0, w - pw + 1, max_patches)
    return np.stack([image[i:i + ph, j:j + pw] for i, j in zip(ii, jj)])
