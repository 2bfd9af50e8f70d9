"""Image resizing, padding, random patches, windows around coordinates,
border cropping and pixel grids (counterpart of
`atomai_tpu/utils/img.py:28-39, 73-97, 190-251, 360-383`)."""

from typing import Dict, Tuple, Union

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


def _window_bounds(coord: np.ndarray, r: int, shape: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Lower corners of r x r windows centred at the rounded coordinates,
    and whether each lies wholly inside ``shape``."""
    centers = np.around(np.asarray(coord)[:, :2]).astype(np.int64)
    lo = centers - r // 2              # the window spans [lo, lo + r)
    valid = ((lo[:, 0] >= 0) & (lo[:, 1] >= 0) &
             (lo[:, 0] + r <= shape[0]) & (lo[:, 1] + r <= shape[1]))
    return lo, valid


def extract_subimages(imgdata: np.ndarray,
                      coordinates: Union[Dict, np.ndarray],
                      window_size: int, coord_class: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``window_size`` windows around the coordinates of class
    ``coord_class`` ({frame: (n, 3) [row, col, class]}, or (n, 2) rows
    and columns of one image) of a stack (n, h, w[, c]) or one image (h,
    w): (windows (m, r, r[, c]), their centres (m, 2), their frames (m,)),
    frame by frame in coordinate order, in one gather. Windows that leave
    the image or hold a NaN are dropped."""
    if isinstance(coordinates, np.ndarray):
        coordinates = {0: np.concatenate(
            (coordinates, np.zeros((coordinates.shape[0], 1))), axis=-1)}
    if np.ndim(imgdata) == 2:
        imgdata = imgdata[None, ..., None]
    r = window_size
    empty = (np.empty((0, r, r) + imgdata.shape[3:], imgdata.dtype),
             np.empty((0, 2)), np.empty((0,), np.int64))
    coord_sel, frame_sel = [], []
    # a dict with more frames than images stops at the image count
    for i, coord in zip(range(imgdata.shape[0]), coordinates.values()):
        coord_i = coord[coord[:, 2] == coord_class][:, :2]
        coord_sel.append(coord_i)
        frame_sel.append(np.full(len(coord_i), i, np.int64))
    if not coord_sel or not sum(len(c) for c in coord_sel):
        return empty
    coord_all = np.concatenate(coord_sel)
    lo, valid = _window_bounds(coord_all, r, imgdata.shape[1:3])
    if not valid.any():
        return empty
    lo, frames = lo[valid], np.concatenate(frame_sel)[valid]
    coms = coord_all[valid]
    rows = lo[:, 0, None] + np.arange(r)
    cols = lo[:, 1, None] + np.arange(r)
    subimages = imgdata[frames[:, None, None], rows[:, :, None],
                        cols[:, None, :]]
    finite = ~np.isnan(subimages).reshape(len(subimages), -1).any(axis=1)
    return subimages[finite], coms[finite], frames[finite]


def crop_borders(imgdata: np.ndarray, thresh: float = 0) -> np.ndarray:
    """Crops each channel of an (h, w, c) array to the rows and columns
    that hold a value above ``thresh``."""
    def crop(img):
        mask = img > thresh
        return img[np.ix_(mask.any(1), mask.any(0))]
    return np.array([crop(imgdata[..., i])
                     for i in range(imgdata.shape[-1])]).transpose(1, 2, 0)


def get_coord_grid(imgdata: np.ndarray, step: int,
                   return_dict: bool = True
                   ) -> Union[np.ndarray, Dict[int, np.ndarray]]:
    """The pixel grid of stride ``step`` over each frame of (n, h, w) (or
    one (h, w) image), row-major: {frame: (m, 3) [row, col, 0]}, or the
    frames' (m, 2) grids stacked when not ``return_dict``."""
    if np.ndim(imgdata) == 2:
        imgdata = np.expand_dims(imgdata, axis=0)
    ii, jj = np.meshgrid(np.arange(0, imgdata.shape[1], step),
                         np.arange(0, imgdata.shape[2], step), indexing="ij")
    coord = np.stack([ii.ravel(), jj.ravel()], -1).astype(float)
    if return_dict:
        coord = np.concatenate((coord, np.zeros((len(coord), 1))), axis=-1)
        return {i: coord for i in range(imgdata.shape[0])}
    return np.concatenate([coord] * imgdata.shape[0], axis=0)


def load_image(image_path: str) -> np.ndarray:
    """An image from a ``.npy`` file (uint8 as it is; anything else
    min-max scaled to uint8) or a standard image format through PIL, as
    RGB (JAX `img.py:486-500`; PIL is imported on use)."""
    import os
    ext = os.path.splitext(image_path)[1].lower()
    if ext == ".npy":
        img_array = np.load(image_path)
        if img_array.dtype == np.uint8:
            return img_array
        a = img_array.astype(np.float64)
        lo, hi = np.min(a), np.max(a)
        return ((a - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
    from PIL import Image
    return np.asarray(Image.open(image_path).convert("RGB"))
