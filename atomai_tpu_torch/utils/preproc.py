"""Data canonicalisation, splitting and batching, channel-last (numpy only).

Counterpart of `atomai_tpu/utils/preproc.py:23-148, 151-220`. Everything
here runs on the host; the trainers move the stacked batches to the device
once.
"""

from typing import List, Optional, Tuple

import numpy as np


def num_classes_from_labels(labels: np.ndarray) -> int:
    """The number of classes of integer masks; a 0/1 mask is one class."""
    uval = np.unique(labels)
    if min(uval) != 0:
        raise AssertionError("Labels should start from 0")
    for i, j in zip(uval, uval[1:]):
        if j - i != 1:
            raise AssertionError("Mask values should be in range between "
                                 "0 and total number of classes "
                                 "with an increment of 1")
    num_classes = len(uval)
    if num_classes == 2:
        num_classes = num_classes - 1
    return num_classes


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


def squeeze_mask_channels(y: np.ndarray) -> np.ndarray:
    """Label masks -> (n, h, w): squeezes a singleton channel dim."""
    y = np.asarray(y)
    if y.ndim == 4:
        if y.shape[1] == 1:
            y = y[:, 0]
        elif y.shape[-1] == 1:
            y = y[..., 0]
        else:
            raise AssertionError(
                "Multichannel masks should be passed as integer masks "
                "(n, h, w)")
    return y


def check_image_dims(X_train, y_train, X_test, y_test, num_classes: int
                     ) -> Tuple[np.ndarray, ...]:
    """Images -> NHWC, masks -> (n, h, w)."""
    return (as_channel_last_images(X_train), squeeze_mask_channels(y_train),
            as_channel_last_images(X_test), squeeze_mask_channels(y_test))


def cast_image_arrays(X_train, y_train, X_test, y_test, num_classes: int
                      ) -> Tuple[np.ndarray, ...]:
    """Training dtypes: float32 images; int64 masks for several classes
    (torch's label dtype; the JAX package uses int32), float32 masks for
    one."""
    ydtype = np.int64 if num_classes > 1 else np.float32
    return (np.asarray(X_train, np.float32), np.asarray(y_train, ydtype),
            np.asarray(X_test, np.float32), np.asarray(y_test, ydtype))


def check_signal_dims(X_train, y_train, X_test, y_test
                      ) -> Tuple[np.ndarray, ...]:
    """(image, spectrum) pairs of ImSpec: a singleton channel axis, first
    or last, is squeezed, so images are (n, h, w) and spectra (n, length);
    train and test must agree."""
    def squeeze1(a):
        a = np.asarray(a)
        if a.ndim >= 3 and a.shape[1] == 1:
            return a[:, 0]
        if a.ndim >= 3 and a.shape[-1] == 1:
            return a[..., 0]
        return a
    X_train, y_train = squeeze1(X_train), squeeze1(y_train)
    X_test, y_test = squeeze1(X_test), squeeze1(y_test)
    if X_train.shape[1:] != X_test.shape[1:] or \
            y_train.shape[1:] != y_test.shape[1:]:
        raise ValueError("The image/spectra dimensions must be the same "
                         "for training and test data")
    return X_train, y_train, X_test, y_test


def format_spectra(spectra: np.ndarray, norm: bool = False) -> np.ndarray:
    """(n, length) float32 spectra (a singleton channel axis squeezed),
    optionally min-max normalized over the whole set."""
    spectra = np.asarray(spectra)
    if spectra.ndim == 3:
        if spectra.shape[1] == 1:
            spectra = spectra[:, 0]
        elif spectra.shape[-1] == 1:
            spectra = spectra[..., 0]
        else:
            raise AssertionError(
                "3D spectra tensor must have a singleton channel dim")
    if spectra.ndim != 2:
        raise AssertionError(
            "Provide spectrum(s) as 2D (n, length) or 3D tensor")
    spectra = spectra.astype(np.float32)
    if norm:
        ptp = np.ptp(spectra)
        spectra = (spectra - spectra.min()) / max(ptp, 1e-12)
    return spectra


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


def data_split(X_train, y_train, test_size: float = 0.15,
               random_state: int = 1, channel: Optional[str] = None
               ) -> Tuple[np.ndarray, ...]:
    """Shuffled train/test split: the first ``round(n * test_size)`` (at
    least 1) of a ``RandomState(random_state)`` permutation are held out,
    as in the JAX package, so both split a data set the same way."""
    X_train = np.asarray(X_train)
    y_train = np.asarray(y_train)
    if channel == "first":
        X_train = X_train[:, None]
        y_train = y_train[:, None]
    elif channel == "last":
        X_train = X_train[..., None]
        y_train = y_train[..., None]
    elif channel is not None:
        raise NotImplementedError(
            f"{channel} channel format is not implemented. "
            "Choose between 'first', 'last'")
    n = len(X_train)
    n_test = max(int(round(n * test_size)), 1)
    perm = np.random.RandomState(random_state).permutation(n)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return (X_train[train_idx], y_train[train_idx],
            X_train[test_idx], y_train[test_idx])


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


def create_batches(array, batch_size: int) -> List[np.ndarray]:
    """Splits an array into batches; the last may be shorter."""
    num_batches = (array.shape[0] + batch_size - 1) // batch_size
    return [array[i * batch_size:(i + 1) * batch_size]
            for i in range(num_batches)]


def stack_batches(x: np.ndarray, batch_size: int) -> np.ndarray:
    """(N, ...) -> (n_batches, batch_size, ...), the remainder dropped; a
    single batch of N when N < batch_size."""
    x = np.asarray(x)
    n = x.shape[0]
    if n < batch_size:
        return x[None]
    nb = n // batch_size
    return x[:nb * batch_size].reshape((nb, batch_size) + x.shape[1:])


def prepare_gp_input(sparse_image: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse image -> (indices of its nonzero pixels, their values, the
    indices of every pixel) (`atomai_tpu/utils/preproc.py:223-231`)."""
    non_zero_indices = np.nonzero(sparse_image)
    gp_input = np.column_stack(non_zero_indices)
    targets = sparse_image[non_zero_indices]
    full_indices = np.array(np.meshgrid(
        *[np.arange(dim) for dim in sparse_image.shape])).T.reshape(
        -1, sparse_image.ndim)
    return gp_input, targets, full_indices


def preprocess_denoiser_data(X_train, y_train, X_test, y_test
                             ) -> Tuple[np.ndarray, ...]:
    """Noisy/clean image pairs as NHWC float32; a single 2-D image gets a
    batch axis and a channel axis."""
    out = []
    for a in (X_train, y_train, X_test, y_test):
        a = np.asarray(a, np.float32)
        out.append(a[None, ..., None] if a.ndim == 2
                   else as_channel_last_images(a))
    return tuple(out)
