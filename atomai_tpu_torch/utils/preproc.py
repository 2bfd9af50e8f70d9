"""Image canonicalization, channel-last (numpy only).

Counterpart of `atomai_tpu/utils/preproc.py:39-54, 113-127, 192-201`.
"""

import numpy as np


def as_channel_last_images(X: np.ndarray) -> np.ndarray:
    """(n, h, w) -> (n, h, w, 1); (n, 1, h, w) -> (n, h, w, 1);
    channel-last input passes through."""
    X = np.asarray(X)
    if X.ndim == 3:
        return X[..., None]
    if X.ndim == 4:
        if X.shape[1] == 1 and X.shape[-1] != 1:
            return np.transpose(X, (0, 2, 3, 1))
        if X.shape[-1] == 1:
            return X
        if X.shape[1] <= 4 < X.shape[-1]:
            # looks like NCHW with few channels
            return np.transpose(X, (0, 2, 3, 1))
        return X
    raise AssertionError("Provide image(s) as 3D (n, h, w) or 4D tensor")


def format_image(image_data: np.ndarray, norm: bool = True) -> np.ndarray:
    """NHWC float32 images, optionally min-max normalized to (0, 1) over
    the whole stack."""
    image_data = np.asarray(image_data)
    if image_data.ndim == 2:
        image_data = image_data[None]
    if image_data.ndim not in (3, 4):
        raise AssertionError(
            "Provide image(s) as 3D (n, h, w) or 4D (n, h, w, c) tensor")
    image_data = as_channel_last_images(image_data).astype(np.float32)
    if norm:
        ptp = np.ptp(image_data)
        image_data = (image_data - image_data.min()) / max(ptp, 1e-12)
    return image_data


def to_onehot(idx: np.ndarray, n: int) -> np.ndarray:
    """(k,) or (k, 1) integer labels -> (k, n) float32 one-hot rows."""
    idx = np.asarray(idx).astype(np.int64)
    if idx.ndim == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    if idx.max() >= n:
        raise AssertionError(
            "Labelling must start from 0 and maximum label value must be "
            "less than total number of classes")
    return np.eye(n, dtype=np.float32)[idx]
