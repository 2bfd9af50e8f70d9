"""The original atomai's utils surface (counterpart of
`atomai_tpu/utils/compat.py`).

Names the original package star-exports from ``atomai.utils`` that have a
direct counterpart here, kept in one module and re-exported from
``atomai_tpu_torch.utils``. Where the JAX package had to stand in for
torch, the port uses torch itself: the data loaders are
``torch.utils.data.DataLoader``s, ``Hook`` is a set of forward hooks and
``dummy_optimizer`` builds a ``torch.optim.Optimizer``. The staging
functions are numpy, as the JAX package's, and give the same arrays,
except that several-class masks are int64 (torch's label dtype) where the
JAX package's are int32.
"""

import warnings
from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.data import DataLoader, TensorDataset

from ..core.checkpoint import is_jax_tree, load_checkpoint
from . import preproc as _preproc
from .coords import get_intensities_  # noqa: F401
from .graphx import filter_subgraphs_  # noqa: F401
from .img import (extract_patches_, filter_cells_,  # noqa: F401
                  imcrop_randcoord, imcrop_randpx)
from .imgen import create_multiclass_lattice_mask_  # noqa: F401
from .nn import renumerate_classes_  # noqa: F401
from .preproc import create_batches, preprocess_denoiser_data  # noqa: F401
from .viz import (animation_from_png, plot_lattice_bonds,  # noqa: F401
                  plot_trajectories, plot_trajectories_transitions,
                  plot_transitions, visualize_unmixing_results)


# --------------------------------------------------------------- formats
def torch_format_image(image_data: np.ndarray, norm: bool = True
                       ) -> np.ndarray:
    """``format_image``: NHWC float32, as the JAX package's (the port's
    trainers take channel-last batches and permute them themselves)."""
    return _preproc.format_image(image_data, norm)


def torch_format_spectra(spectra: np.ndarray, norm: bool = False
                         ) -> np.ndarray:
    """``format_spectra``: (n, length) float32."""
    return _preproc.format_spectra(spectra, norm)


def torch_format(image_data: np.ndarray) -> np.ndarray:
    """Deprecated alias of ``format_image``."""
    warnings.warn("torch_format is deprecated. Use format_image instead",
                  UserWarning)
    return _preproc.format_image(image_data)


def train_test_split(X, y, test_size: float = 0.15, shuffle: bool = True,
                     random_state: int = 1):
    """sklearn-ordered (X_tr, X_ts, y_tr, y_ts). ``shuffle=False`` holds
    out the last frames, in order; otherwise ``data_split``'s draw."""
    if not shuffle:
        X, y = np.asarray(X), np.asarray(y)
        n_test = max(int(round(len(X) * test_size)), 1)
        return X[:-n_test], X[-n_test:], y[:-n_test], y[-n_test:]
    X_tr, y_tr, X_ts, y_ts = _preproc.data_split(X, y, test_size,
                                                 random_state)
    return X_tr, X_ts, y_tr, y_ts


# ------------------------------------------------------------- batching
def array2list_(x, batch_size: int, store_on_cpu: bool = False
                ) -> List[np.ndarray]:
    """Equal-size batches of ``x``, the remainder dropped; raises when
    ``batch_size`` exceeds the samples."""
    x = np.asarray(x)
    n_batches = x.shape[0] // batch_size
    if n_batches == 0:
        raise ValueError(
            f"batch_size {batch_size} exceeds the {x.shape[0]} available "
            "samples")
    return list(np.split(x[:n_batches * batch_size], n_batches))


def array2list(X_train, y_train, X_test, y_test, batch_size: int,
               memory_alloc: float = 4):
    """:func:`array2list_` of each array (``memory_alloc`` is accepted
    and unused: the trainers stage data on the device themselves)."""
    return tuple(array2list_(a, batch_size)
                 for a in (X_train, y_train, X_test, y_test))


def get_array_memsize(X_arr, precision: str = "single") -> float:
    """Bytes of ``X_arr`` once cast to the given precision."""
    if X_arr is None:
        return 0
    arr = np.asarray(X_arr)
    arrsize = arr.nbytes
    if precision == "single" and arr.dtype in (np.float64, np.int64):
        arrsize = arrsize / 2
    elif precision == "double" and arr.dtype in (np.float32, np.int32):
        arrsize = arrsize * 2
    return arrsize


def init_dataloader(*arrays, batch_size: int = 32, shuffle: bool = False,
                    **kwargs) -> DataLoader:
    """A ``DataLoader`` of tuples of batches of ``arrays`` (CPU tensors of
    the arrays' dtypes), the last batch possibly shorter. With
    ``shuffle`` the order is one ``np.random.shuffle`` on numpy's global
    state, drawn here once, as the JAX package draws it: a seeded run
    gives the same batches in both, every time the loader is iterated."""
    tensors = [torch.as_tensor(np.asarray(a)) for a in arrays]
    idx = np.arange(len(tensors[0]))
    if shuffle:
        np.random.shuffle(idx)
    return DataLoader(TensorDataset(*tensors), batch_size=batch_size,
                      sampler=idx.tolist())


def init_dataloaders(X_train, y_train, X_test, y_test,
                     batch_size: int = 32, **kwargs
                     ) -> Tuple[DataLoader, DataLoader]:
    """(train, test) loaders, in order."""
    return (init_dataloader(X_train, y_train, batch_size=batch_size),
            init_dataloader(X_test, y_test, batch_size=batch_size))


init_fcnn_dataloaders = init_dataloaders
init_imspec_dataloaders = init_dataloaders
init_reg_dataloaders = init_dataloaders
init_cls_dataloaders = init_dataloaders
init_vae_dataloaders = init_dataloaders


# -------------------------------------------------- task preprocessing
def preprocess_training_image_data(X_train, y_train, X_test, y_test,
                                   batch_size: int,
                                   memory_alloc: float = 4):
    """Images NHWC and masks (n, h, w) in batch lists, and the class
    count inferred from the masks."""
    nb = _preproc.num_classes_from_labels(np.asarray(y_train))
    arrays = _preproc.check_image_dims(X_train, y_train, X_test, y_test, nb)
    return (*array2list(*arrays, batch_size), nb)


def preprocess_training_imspec_data(X_train, y_train, X_test, y_test,
                                    batch_size: int,
                                    memory_alloc: float = 4):
    """(image, spectrum) pairs, a singleton channel squeezed, in batch
    lists."""
    arrays = _preproc.check_signal_dims(X_train, y_train, X_test, y_test)
    return array2list(*arrays, batch_size)


def preprocess_training_reg_data(X_train, y_train, X_test, y_test,
                                 batch_size: int, memory_alloc: float = 4):
    """float32 images and targets in batch lists."""
    return array2list(*(np.asarray(a, np.float32) for a in
                        (X_train, y_train, X_test, y_test)), batch_size)


def preprocess_training_cls_data(X_train, y_train, X_test, y_test,
                                 batch_size: int, memory_alloc: float = 4):
    """float32 images and int32 labels in batch lists (the JAX package's
    dtypes)."""
    return array2list(np.asarray(X_train, np.float32),
                      np.asarray(y_train, np.int32),
                      np.asarray(X_test, np.float32),
                      np.asarray(y_test, np.int32), batch_size)


def preprocess_training_image_data_(images_all, labels_all,
                                    images_test_all, labels_test_all):
    """Images and masks checked and cast without batching (float32
    images; float32 masks for one class, int64 for several), and the
    class count."""
    nb = _preproc.num_classes_from_labels(np.asarray(labels_all))
    arrays = _preproc.check_image_dims(
        images_all, labels_all, images_test_all, labels_test_all, nb)
    return (*_preproc.cast_image_arrays(*arrays, nb), nb)


def preprocess_training_imspec_data_(X_train, y_train, X_test, y_test):
    """im2spec / spec2im pairs checked and cast to float32 without
    batching, and (in_dim, out_dim)."""
    arrays = [np.asarray(a, np.float32) for a in _preproc.check_signal_dims(
        X_train, y_train, X_test, y_test)]
    return (*arrays, (arrays[0].shape[1:], arrays[1].shape[1:]))


def _ensure_channel_and_target_dims(X_train, y_train, X_test, y_test,
                                    ydtype):
    X_train, X_test = np.asarray(X_train), np.asarray(X_test)
    y_train, y_test = np.asarray(y_train), np.asarray(y_test)
    if X_train.ndim == 3:
        warnings.warn("Adding a channel dimension of 1 to training images",
                      UserWarning)
        X_train = X_train[..., None]
    if X_test.ndim == 3:
        warnings.warn("Adding a channel dimension of 1 to test images",
                      UserWarning)
        X_test = X_test[..., None]
    if ydtype is np.float32 and y_train.ndim == 1:
        y_train, y_test = y_train[:, None], y_test[:, None]
    return (X_train.astype(np.float32), y_train.astype(ydtype),
            X_test.astype(np.float32), y_test.astype(ydtype))


def preprocess_training_reg_data_(X_train, y_train, X_test, y_test):
    """Regression data checked and cast without batching: NHWC float32
    images, (n, k) float32 targets."""
    return _ensure_channel_and_target_dims(
        X_train, y_train, X_test, y_test, np.float32)


def preprocess_training_cls_data_(X_train, y_train, X_test, y_test):
    """Classification data checked and cast without batching: NHWC
    float32 images, int32 labels (the JAX package's dtype)."""
    return _ensure_channel_and_target_dims(
        X_train, y_train, X_test, y_test, np.int32)


# ----------------------------------------------------------- nn helpers
def load_weights(model, weights_path: str):
    """Loads a checkpoint's weights (a ``.aoit`` of the port or a ``.aoi``
    of the JAX package) into ``model`` and returns it. ``model`` is one of
    the port's models or trainers (anything with ``load_arrays``), which
    read either file, or a bare ``nn.Module``, which takes the port's
    ``state_dict`` only."""
    _, arrays = load_checkpoint(weights_path)
    if callable(getattr(model, "load_arrays", None)):
        model.load_arrays(arrays)
    elif is_jax_tree(arrays):
        raise ValueError(
            "a JAX checkpoint loads into a model object (Segmentor, VAE, "
            "...) or through load_model, which know its weight bridge; a "
            "bare nn.Module takes the port's state_dict")
    else:
        model.load_state_dict(arrays["params"])
    return model


class Hook:
    """Captures every submodule's output during a forward pass: forward
    hooks on each named submodule, the outputs kept in
    ``intermediates[name]`` (``named_modules()``'s dotted names, the root
    under ""). The JAX package's counterpart captures flax's
    ``capture_intermediates``; the port's nets are NCHW inside, so a
    captured activation is the JAX one transposed.

    Example:
        >>> h = Hook(net)
        >>> out = h(x)
        >>> h.intermediates["c1"]     # the first block's output
        >>> h.close()
    """

    def __init__(self, module: nn.Module):
        self.module = module
        self.intermediates: Dict[str, Any] = {}
        self._handles = [m.register_forward_hook(self._keep(name))
                         for name, m in module.named_modules()]

    def _keep(self, name: str) -> Callable:
        def hook(_module, _inputs, output):
            self.intermediates[name] = output
        return hook

    def __call__(self, x: torch.Tensor, train: bool = False):
        """``module(x)`` in train or eval mode (restored afterwards), with
        the intermediates of this call."""
        self.intermediates = {}
        was_training = self.module.training
        self.module.train(train)
        try:
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                return self.module(x)
        finally:
            self.module.train(was_training)

    def close(self) -> None:
        """Removes the hooks and drops the captured outputs."""
        for h in self._handles:
            h.remove()
        self._handles = []
        self.intermediates = {}


def set_seed_and_precision(seed: int = 1, precision: str = "single"
                           ) -> None:
    """Seeds numpy's and torch's global generators and pins the port's
    precision policy to :meth:`Precision.full` (float32, TF32 off, on
    every device).

    ``precision="double"`` is accepted and changes nothing more: the JAX
    package enables ``jax_enable_x64`` there, which lets float64 arrays
    exist but leaves its nets, their parameters and the staged data in
    float32; torch has float64 always, so the port's nets stay float32 as
    well and torch's default dtype is not touched."""
    from ..core.dtypes import Precision, set_default_precision
    if precision not in ("single", "double"):
        raise ValueError("precision must be 'single' or 'double'")
    np.random.seed(seed)
    torch.manual_seed(seed)
    set_default_precision(Precision.full())


class _Identity(torch.optim.Optimizer):
    """An optimizer whose step leaves every parameter as it is."""

    def __init__(self, params: Iterable[nn.Parameter]):
        super().__init__(params, {})

    def step(self, closure=None):
        return closure() if closure is not None else None


def dummy_optimizer() -> Callable[[Iterable[nn.Parameter]],
                                  torch.optim.Optimizer]:
    """A ``params -> optimizer`` callable (the form the trainers take for
    ``optimizer=``) whose optimizer never changes the weights, as the JAX
    package's ``optax.identity()``."""
    return _Identity


def nb_filters_classes(weights_path: str) -> Tuple[int, int]:
    """(nb_filters, nb_classes) from a checkpoint's metadict."""
    meta, _ = load_checkpoint(weights_path)
    return int(meta.get("nb_filters", 0)), int(meta.get("nb_classes", 0))


def channels2indices(mask: np.ndarray) -> np.ndarray:
    """One-hot channel mask (..., c) -> class-index mask (...), float."""
    mask = np.asarray(mask)
    out = np.zeros(mask.shape[:-1])
    for c in range(mask.shape[-1]):
        out += mask[..., c] * c
    return out


def combine_classes_(coord: np.ndarray,
                     classes_to_combine: List[List[int]]) -> np.ndarray:
    """``combine_classes`` of one (n, 3) coordinate array: every class of
    a group after the first becomes the first."""
    coord_ = coord.copy()
    for comb in classes_to_combine:
        for c in comb[1:]:
            coord_[:, -1][coord_[:, -1] == c] = comb[0]
    return coord_
