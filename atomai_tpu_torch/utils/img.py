"""Image resizing and rotation, padding, random patches and windows,
windows around coordinates, FFT masks, thresholds, blob filtering,
contours and blob ellipses, border cropping and pixel grids (counterpart
of `atomai_tpu/utils/img.py`).

``filter_cells(_)``, ``get_contours`` and ``get_blob_params`` label the
blobs of their masks with ``csrc/cc_label.cu`` on the card (one launch a
frame and call; its plain version for a CPU tensor). A tensor is labelled
on its device, numpy data on ``device`` (default ``"cuda"``, which raises
where torch sees no card); the outputs are numpy, as in the JAX package.
"""

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cc_kernel import label_components
from ..ops.cc_label import labels_and_sums
from .coords import as_device_tensor, remove_edge_coord


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


def cv_resize(img: np.ndarray, rs: Tuple[int, int],
              round_: bool = False) -> np.ndarray:
    """Resizes one image (h, w[, c]) to ``rs`` as :func:`img_resize`
    does a stack."""
    img = np.asarray(img)
    if img.shape[:2] == tuple(rs):
        return img.copy()
    return img_resize(img[None], rs, round_)[0]


def cv_resize_stack(imgdata: np.ndarray, rs: Union[int, Tuple[int, int]],
                    round_: bool = False) -> np.ndarray:
    """Resizes a stack (n, h, w[, c]) to ``rs`` (an int for a square)."""
    if isinstance(rs, int):
        rs = (rs, rs)
    return img_resize(imgdata, rs, round_)


def cv_rotate(img: np.ndarray, a: float) -> np.ndarray:
    """Rotates an image (h, w[, c]) by ``a`` degrees counter-clockwise
    about its centre: ``np.rot90`` for multiples of 90, else the bilinear
    warp of ``transforms.warp.rotate_image`` (float32)."""
    if a % 90 == 0:
        return np.rot90(img, int(a // 90) % 4).copy()
    from ..transforms.warp import rotate_image
    return rotate_image(torch.from_numpy(np.asarray(img, np.float32)),
                        np.deg2rad(a)).numpy()


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


def extract_patches_(lattice_im: np.ndarray, lattice_mask: np.ndarray,
                     patch_size: Union[int, Tuple[int, int]],
                     num_patches: int, **kwargs: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``num_patches`` random patches of an image and the same patches of
    its mask (``random_state``, default 0)."""
    rs = kwargs.get("random_state", 0)
    if isinstance(patch_size, int):
        patch_size = (patch_size, patch_size)
    images = extract_patches_2d(lattice_im, patch_size, num_patches, rs)
    labels = extract_patches_2d(lattice_mask, patch_size, num_patches, rs)
    return images, labels


def extract_patches(images: np.ndarray, masks: np.ndarray,
                    patch_size: Union[int, Tuple[int, int]],
                    num_patches: int, **kwargs: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`extract_patches_` of each image/mask pair of two stacks (or
    of one pair), concatenated."""
    if np.ndim(images) == 2:
        images = images[None, ...]
    if np.ndim(masks) == 2:
        masks = masks[None, ...]
    pairs = [extract_patches_(im, ma, patch_size, num_patches, **kwargs)
             for im, ma in zip(images, masks)]
    return (np.concatenate([p[0] for p in pairs], 0),
            np.concatenate([p[1] for p in pairs], 0))


def _window_bounds(coord: np.ndarray, r: int, shape: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Lower corners of r x r windows centred at the rounded coordinates,
    and whether each lies wholly inside ``shape``."""
    centers = np.around(np.asarray(coord)[:, :2]).astype(np.int64)
    lo = centers - r // 2              # the window spans [lo, lo + r)
    valid = ((lo[:, 0] >= 0) & (lo[:, 1] >= 0) &
             (lo[:, 0] + r <= shape[0]) & (lo[:, 1] + r <= shape[1]))
    return lo, valid


def get_imgstack(imgdata: np.ndarray, coord: np.ndarray, r: int
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The r x r windows of one image centred at the rounded coordinates,
    in one gather, and their coordinates: windows that leave the image or
    hold a NaN are dropped; (None, None) when none is left."""
    coord = np.asarray(coord)
    if len(coord) == 0:
        return None, None
    lo, valid = _window_bounds(coord, r, imgdata.shape[:2])
    if not valid.any():
        return None, None
    rows = lo[valid][:, 0, None] + np.arange(r)
    cols = lo[valid][:, 1, None] + np.arange(r)
    crops = imgdata[rows[:, :, None], cols[:, None, :]]
    finite = ~np.isnan(crops).reshape(crops.shape[0], -1).any(axis=1)
    if not finite.any():
        return None, None
    return crops[finite], coord[valid][finite]


def imcrop_randpx(img: np.ndarray, window_size: int, num_images: int,
                  random_state: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Windows at ``num_images`` distinct random pixels (drawn in batches
    from ``np.random.RandomState(random_state)``, first draws kept) at
    least ``window_size // 2 + 1`` from the edges."""
    rng = np.random.RandomState(random_state)
    x_lo, x_hi = window_size // 2 + 1, img.shape[0] - window_size // 2 - 1
    y_lo, y_hi = window_size // 2 + 1, img.shape[1] - window_size // 2 - 1
    chosen = np.empty((0, 2), np.int64)
    while len(chosen) < num_images:
        draw = max(num_images - len(chosen), 16) * 2
        xy = np.stack([rng.randint(x_lo, x_hi, draw),
                       rng.randint(y_lo, y_hi, draw)], axis=1)
        pool = np.concatenate([chosen, xy])
        _, first = np.unique(pool, axis=0, return_index=True)
        chosen = pool[np.sort(first)]
    return get_imgstack(img, chosen[:num_images], window_size)


def imcrop_randcoord(img: np.ndarray, coord: np.ndarray, window_size: int,
                     num_images: int, random_state: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Windows at ``num_images`` of the coordinates, chosen without
    replacement by ``np.random.RandomState(random_state)``."""
    rng = np.random.RandomState(random_state)
    idx = rng.choice(len(coord), size=num_images, replace=False)
    return get_imgstack(img, coord[idx], window_size)


def extract_random_subimages(imgdata: np.ndarray, window_size: int,
                             num_images: int,
                             coordinates: Optional[Dict] = None,
                             **kwargs: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``num_images`` random windows a frame of a stack (n, h, w[, c]): at
    random pixels, or at random atoms of class ``coord_class`` (default 0)
    of ``coordinates`` away from the edges; frame i draws from seed i.
    Returns (windows (n*num, r, r, c), centres, frames)."""
    coord_class = kwargs.get("coord_class", 0)
    if np.ndim(imgdata) < 4:
        imgdata = imgdata[..., None]
    n = num_images * imgdata.shape[0]
    subimages_all = np.zeros((n, window_size, window_size,
                              imgdata.shape[-1]))
    com_all = np.zeros((n, 2))
    frames_all = np.zeros(n)
    for i, img in enumerate(imgdata):
        if coordinates is None:
            stack_i, com_i = imcrop_randpx(img, window_size, num_images,
                                           random_state=i)
        else:
            coord = coordinates[i]
            coord = coord[coord[:, -1] == coord_class][:, :2]
            coord = remove_edge_coord(coord, imgdata.shape[1:3],
                                      window_size // 2 + 1)
            if num_images > len(coord):
                raise ValueError("Number of images cannot be greater than "
                                 "the available coordinates")
            stack_i, com_i = imcrop_randcoord(img, coord, window_size,
                                              num_images, random_state=i)
        sl = slice(i * num_images, (i + 1) * num_images)
        subimages_all[sl] = stack_i
        com_all[sl] = com_i
        frames_all[sl] = np.ones(len(com_i), int) * i
    return subimages_all, com_all, frames_all


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


def extract_patches_and_spectra(hdata: np.ndarray, *args: np.ndarray,
                                coordinates: np.ndarray = None,
                                window_size: int = None,
                                avg_pool: int = 2, **kwargs
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Windows of a hyperspectral cube (h, w, e) or (h, w, e1, e2) around
    ``coordinates`` and the spectra at their centres, average-pooled by
    ``avg_pool``: (patches, spectra, centres). The image is ``args[0]``,
    or the mean of the cube over the energy band(s) ``band`` (default 0:
    the first slice)."""
    if hdata.ndim not in (3, 4):
        raise ValueError("Hyperspectral data must be 3D or 4D")
    if len(args) > 0:
        img = args[0]
        if img.ndim != 2:
            raise ValueError("Image data must be 2D")
    else:
        band = kwargs.get("band", 0)
        n_axes = hdata.ndim - 2
        if isinstance(band, int):
            band = [band, band + 1] * n_axes
        elif len(band) == 2 and n_axes == 2:
            band = [*band, *band]
        sel = (Ellipsis,) + tuple(slice(band[2 * i], band[2 * i + 1])
                                  for i in range(n_axes))
        img = hdata[sel].mean(tuple(range(-n_axes, 0)))
    patches, coords, _ = extract_subimages(img, coordinates, window_size)
    patches = patches.squeeze()
    cij = np.asarray(coords).astype(np.int64)
    spectra = np.asarray(hdata)[cij[:, 0], cij[:, 1]]
    if hdata.ndim == 3:
        k = avg_pool
        n = (spectra.shape[-1] // k) * k
        spectra = spectra[..., :n].reshape(
            spectra.shape[0], -1, k).mean(-1)
    else:
        k = (avg_pool, avg_pool) if isinstance(avg_pool, int) else avg_pool
        s0, h_, w_ = spectra.shape
        h2, w2 = (h_ // k[0]) * k[0], (w_ // k[1]) * k[1]
        spectra = spectra[:, :h2, :w2].reshape(
            s0, h2 // k[0], k[0], w2 // k[1], k[1]).mean((2, 4))
    return patches, spectra, coords


def FFTmask(imgsrc: np.ndarray, maskratio: int = 10
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The centred FFT of a square image and the same with a centre disk
    of radius ``h / maskratio`` zeroed."""
    F2 = np.fft.fftshift(np.fft.fft2(imgsrc))
    F3 = F2.copy()
    l = int(imgsrc.shape[0] / maskratio)  # noqa: E741
    m = int(imgsrc.shape[0] / 2)
    y, x = np.ogrid[1:2 * l + 1, 1:2 * l + 1]
    mask = (x - l) * (x - l) + (y - l) * (y - l) <= l * l
    F3[m - l:m + l, m - l:m + l] = F3[m - l:m + l, m - l:m + l] * (1 - mask)
    return F2, F3


def FFTsub(imgsrc: np.ndarray, imgfft: np.ndarray) -> np.ndarray:
    """|image - the inverse of a centred FFT|, scaled to [0, 1]."""
    reconstruction = np.real(np.fft.ifft2(np.fft.ifftshift(imgfft)))
    diff = np.abs(imgsrc - reconstruction)
    diff = diff - np.amin(diff)
    return diff / np.amax(diff)


def threshImg(diff: np.ndarray, threshL: float = 0.25,
              threshH: float = 0.75) -> np.ndarray:
    """The pixels of a difference image below ``threshL`` or above
    ``threshH`` (bool)."""
    return (diff < threshL) + (diff > threshH)


def cv_thresh(imgdata: np.ndarray, threshold: float = .5) -> np.ndarray:
    """1.0 where ``imgdata > threshold`` (strictly), else 0.0; float32."""
    return (np.asarray(imgdata) > threshold).astype(np.float32)


def _size_filtered(mask: torch.Tensor, blob_thresh: int,
                   filter_: str) -> torch.Tensor:
    """The pixels of a (H, W) bool mask whose 4-connected blob has at
    least ``blob_thresh`` pixels (at most, with ``filter_="above"``): one
    labeller launch; the blob sizes are its fused counts."""
    lab, (roots, counts, _, _) = labels_and_sums(mask)
    size_of = torch.zeros(mask.numel() + 1, dtype=torch.int64,
                          device=mask.device)
    size_of[roots] = counts                 # background (H*W) keeps 0
    blob_size = size_of[lab.long()]
    keep = blob_size <= blob_thresh if filter_ == "above" \
        else blob_size >= blob_thresh
    return mask & keep


def filter_cells_(imgdata: Union[np.ndarray, torch.Tensor],
                  im_thresh: float = .5, blob_thresh: int = 150,
                  filter_: str = "below",
                  device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """One frame (H, W) thresholded at ``im_thresh`` (strictly), with the
    blobs of fewer than ``blob_thresh`` pixels removed (of more, with
    ``filter_="above"``), in the input's dtype."""
    mask = as_device_tensor(imgdata, device) > im_thresh
    keep = _size_filtered(mask, blob_thresh, filter_)
    if isinstance(imgdata, torch.Tensor):
        return keep.to(imgdata.dtype).cpu().numpy()
    return keep.cpu().numpy().astype(np.asarray(imgdata).dtype)


def filter_cells(imgdata: Union[np.ndarray, torch.Tensor],
                 im_thresh: float = 0.5, blob_thresh: int = 50,
                 filter_: str = "below",
                 device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """:func:`filter_cells_` of each frame of a stack (n, H, W)."""
    return np.stack([filter_cells_(img, im_thresh, blob_thresh, filter_,
                                   device) for img in imgdata])


def get_contours(imgdata: Union[np.ndarray, torch.Tensor],
                 device: Union[str, torch.device] = "cuda"
                 ) -> List[np.ndarray]:
    """The boundary pixels (those with a 4-neighbour outside the mask or
    on the frame's edge) of each blob of ``imgdata > 0`` (H, W): one
    (m, 2) int64 array [x, y] = [col, row] a blob in raster order, blobs
    in the raster order of their first pixel (the JAX package's
    replacement of ``cv2.findContours``). One labeller launch, then one
    stable sort of the boundary pixels by label."""
    mask = as_device_tensor(imgdata, device) > 0
    H, W = mask.shape
    lab = label_components(mask)
    interior = torch.zeros_like(mask)
    interior[1:-1, 1:-1] = (mask[1:-1, 1:-1] & mask[:-2, 1:-1] &
                            mask[2:, 1:-1] & mask[1:-1, :-2] &
                            mask[1:-1, 2:])
    pix = torch.nonzero((mask & ~interior).reshape(-1)).squeeze(1)
    if not len(pix):
        return []
    owner, order = torch.sort(lab.reshape(-1)[pix], stable=True)
    _, counts = torch.unique_consecutive(owner, return_counts=True)
    pix = pix[order].cpu().numpy()
    xy = np.stack([pix % W, pix // W], axis=1)
    return np.split(xy, np.cumsum(counts.cpu().numpy())[:-1])


def _central(n: np.ndarray, s1: np.ndarray, s2: np.ndarray,
             t1: np.ndarray, t2: np.ndarray, st: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Central second moments (float64) of blobs from exact int64 raw sums
    (counts ``n``, sums ``s1``, ``t1``, sums of squares ``s2``, ``t2``,
    cross sums ``st``): the sums are first shifted, exactly, to an integer
    origin near each mean, so that little cancels in float64."""
    c1, d1 = np.round(s1 / n).astype(np.int64), np.round(t1 / n).astype(
        np.int64)
    u1, v1 = s1 - n * c1, t1 - n * d1                 # sums about (c, d)
    u2 = s2 - 2 * c1 * s1 + n * c1 * c1
    v2 = t2 - 2 * d1 * t1 + n * d1 * d1
    uv = st - d1 * s1 - c1 * t1 + n * c1 * d1
    mu, mv = u1 / n, v1 / n
    return u2 / n - mu * mu, v2 / n - mv * mv, uv / n - mu * mv


def _blob_moments(mask: torch.Tensor
                  ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(centres (k, 2) [x, y], orientation angles (k,) in degrees as
    ``cv2.fitEllipse`` gives them) of the blobs of at least 5 pixels of a
    (H, W) bool mask, in the raster order of their first pixel; (None,
    None) for an empty mask. One labeller launch for the labels, counts
    and first sums; the second sums by ``index_add_`` of int64 on the
    labels. Every sum is exact, so the card and the CPU give the same
    bits."""
    H, W = mask.shape
    lab, (roots, n, ys, xs) = labels_and_sums(mask)
    if not len(roots):
        return None, None
    blob_of = torch.full((H * W + 1,), -1, dtype=torch.int64,
                         device=mask.device)
    blob_of[roots] = torch.arange(len(roots), device=mask.device)
    pix = torch.nonzero(mask.reshape(-1)).squeeze(1)
    k = blob_of[lab.reshape(-1)[pix].long()]
    y, x = pix // W, pix % W
    second = torch.zeros((3, len(roots)), dtype=torch.int64,
                         device=mask.device)
    for row, v in enumerate((y * y, x * x, x * y)):
        second[row].index_add_(0, k, v)
    n, ys, xs = (t.cpu().numpy() for t in (n, ys, xs))
    yy, xx, xy = second.cpu().numpy()
    cyy, cxx, cxy = _central(n, ys, yy, xs, xx, xy)
    angles = 0.5 * np.degrees(np.arctan2(2 * cxy, cxx - cyy)) + 90.0
    com = np.stack([xs / n, ys / n], axis=1)
    big_enough = n >= 5
    return com[big_enough], angles[big_enough]


def get_blob_params(nn_output: Union[np.ndarray, torch.Tensor],
                    im_thresh: float, blob_thresh: int,
                    filter_: str = "below",
                    device: Union[str, torch.device] = "cuda") -> Dict:
    """Per frame of (n, H, W[, 1]) maps: the map (``"decoded"``), and the
    centres [x, y] (``"coordinates"``) and angles (``"angles"``) of the
    blobs of at least 5 pixels left by :func:`filter_cells_`. Two
    labeller launches a frame."""
    blob_dict = {}
    if nn_output.ndim == 4:
        nn_output = nn_output[..., 0]
    for i, frame in enumerate(nn_output):
        mask = as_device_tensor(frame, device) > im_thresh
        com_arr, angles = _blob_moments(
            _size_filtered(mask, blob_thresh, filter_))
        dictionary = OrderedDict()
        dictionary["decoded"] = frame
        dictionary["coordinates"] = com_arr
        dictionary["angles"] = np.asarray(angles) if angles is not None \
            else np.array([])
        blob_dict[i] = dictionary
    return blob_dict


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
