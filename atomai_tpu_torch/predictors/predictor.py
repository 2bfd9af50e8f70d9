"""Inference and post-processing to atomic coordinates.

Counterpart of `atomai_tpu/predictors/predictor.py:57-452, 455-563`:

- :class:`BasePredictor`: eval-mode forward in chunks, under the device's
  precision policy;
- :class:`SegPredictor`: preprocess (channel fix-ups, optional resize, pad
  bottom/right to the net's downsample factor, min-max normalise over the
  whole stack), forward, sigmoid/softmax; NHWC maps out;
- :class:`ImSpecPredictor`: images to spectra or spectra to images;
- :class:`RegPredictor`, :class:`clsPredictor`: images to values, and to
  class labels (the argmax);
- :class:`Locator`: background channel for one-class output, threshold,
  connected-component labels and centres of mass for all frames at once,
  edge removal, and with ``refine`` a batched 2D-Gaussian fit of every
  atom on the device. Output: ``{frame: (n, 3) [row, col, class]}``.

``SegPredictor.run`` keeps the maps on the device: thresholds, labels and
moments are taken there, and only the coordinates and the NHWC maps that
the caller gets back are copied to the host.

Every predictor takes ``mesh`` (`atomai_tpu/predictors/predictor.py:95-131,
171-181`): in a world of several ranks ``None`` builds a data mesh over
all of them, ``False`` gives none, a ``DeviceMesh`` is used as given. Each
forward chunk is then padded along its frame axis to a multiple of the
data axis, each rank forwards its block, the blocks are all-gathered and
the padding trimmed, so every rank holds the whole output. The input is
preprocessed (and min-max normalised) whole before it is split, as one
process normalises it; ``SegPredictor.run`` then locates atoms on every
rank (one labeller launch a rank on the card). Not ported: the JAX
package's reduced-precision ``fetch_dtype`` wire.
"""

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..core import profiling
from ..core.device import resolve_device
from ..core.dtypes import default_precision
from ..core.mesh import (DATA_AXIS, axis_size, gather_blocks,
                         resolve_data_mesh, shard_batch, splits)
from ..nets.fcnn import DOWNSAMPLE_FACTORS
from ..ops.cc_label import blob_centers_tiled
from ..ops.peakfit import refine_peaks
from ..utils.coords import mean_nn_distance
from ..utils.img import img_pad, img_resize
from ..utils.preproc import format_image, format_spectra


class BasePredictor:
    """Eval-mode forward of ``model`` in chunks, on the model's device,
    under that device's precision policy. Keyword args: ``verbose``,
    ``mesh`` (the data mesh the frames split over: None for the automatic
    one, False for none, or a ``DeviceMesh``)."""

    def __init__(self, model: nn.Module, **kwargs):
        self.model = model
        self.device = next(model.parameters()).device
        self.precision = default_precision(self.device)
        self.verbose = kwargs.get("verbose", False)
        self.mesh = resolve_data_mesh(kwargs.get("mesh", None))

    @staticmethod
    def _minmax(x: torch.Tensor) -> torch.Tensor:
        """``x`` min-max normalised over the whole stack on its device, by
        the JAX package's formula: (x - min) / max(max - min, 1e-12)."""
        lo = x.min()
        return (x - lo) / torch.clamp(x.max() - lo, min=1e-12)

    def preprocess(self, data) -> torch.Tensor:
        """``data`` as a float32 tensor on the model's device."""
        with profiling.span("predictor.preprocess"):
            data = np.asarray(data, np.float32)
            with profiling.span("predictor.upload"):
                return torch.as_tensor(data, device=self.device)

    def forward_(self, x: torch.Tensor) -> torch.Tensor:
        """One forward pass of a batch (NCHW for images); under a data mesh
        each rank forwards its block of the frames, padded to the data
        axis, and every rank gets the whole output."""
        if not splits(self.mesh, DATA_AXIS):
            with self.precision.scope(self.device):
                return self.model(x)
        n = len(x)
        pad = (-n) % axis_size(self.mesh, DATA_AXIS)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        with self.precision.scope(self.device):
            out = self.model(shard_batch(self.mesh, x))
        return gather_blocks(out, self.mesh, DATA_AXIS)[:n]

    def batch_forward(self, x: torch.Tensor, num_batches: int
                      ) -> torch.Tensor:
        """Forward of ``x`` in ``num_batches`` chunks plus a remainder
        chunk (`atomai_tpu/predictors/predictor.py:194-219`); the result
        stays on the device."""
        with profiling.span("predictor.forward"):
            return self._batch_forward(x, num_batches)

    def _batch_forward(self, x: torch.Tensor, num_batches: int
                       ) -> torch.Tensor:
        batch_size = len(x) // num_batches
        if batch_size < 1:
            num_batches, batch_size = 1, len(x)
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for i in range(num_batches):
                if self.verbose:
                    print("\rBatch {}/{}".format(i + 1, num_batches), end="")
                outs.append(self.forward_(
                    x[i * batch_size:(i + 1) * batch_size]))
            if num_batches * batch_size < len(x):
                outs.append(self.forward_(x[num_batches * batch_size:]))
        return torch.cat(outs)

    def batch_predict(self, data: torch.Tensor, out_shape: Tuple[int, ...],
                      num_batches: int) -> np.ndarray:
        """:meth:`batch_forward` copied to the host in one transfer, as
        float32 numpy of ``out_shape``."""
        out = self.batch_forward(data, num_batches)
        return out.float().cpu().numpy().reshape(out_shape)

    def predict(self, data, out_shape: Optional[Tuple[int, ...]] = None,
                num_batches: int = 1) -> np.ndarray:
        """The model's output for ``data`` as it is given (no layout
        change), of ``data``'s shape or (n, *out_shape)."""
        out_shape = tuple(np.shape(data)) if out_shape is None \
            else (len(data), *out_shape)
        return self.batch_predict(self.preprocess(data), out_shape,
                                  num_batches)


class SegPredictor(BasePredictor):
    """Segmentation predictor: NHWC probability maps of an NCHW net.

    Keyword args besides :class:`BasePredictor`'s: ``nb_classes``,
    ``downsampling`` (default from the net's class), ``thresh`` (0.5),
    ``num_batches``, ``norm``, and ``d``, the window half-side of
    ``refine`` (default: a quarter of each frame's mean nearest-neighbour
    distance).
    """

    def __init__(self, model: nn.Module, refine: bool = False,
                 resize: Optional[Tuple[int, int]] = None,
                 logits: bool = True, **kwargs):
        super().__init__(model, **kwargs)
        self.refine = refine
        self.d = kwargs.get("d")
        self.nb_classes = kwargs.get("nb_classes") or \
            getattr(model, "nb_classes", 1)
        self.downsampling = kwargs.get("downsampling") or \
            DOWNSAMPLE_FACTORS.get(type(model).__name__, 8)
        self.resize = resize
        self.logits = logits
        self.thresh = kwargs.get("thresh", .5)
        self.verbose = kwargs.get("verbose", True)

    def preprocess(self, image_data: np.ndarray, norm: bool = True
                   ) -> torch.Tensor:
        """(N?, H, W[, 1]) -> padded NHWC float32 tensor on the device,
        min-max normalised over the whole stack
        (`atomai_tpu/predictors/predictor.py:277-294`)."""
        with profiling.span("predictor.preprocess"):
            image_data = np.asarray(image_data)
            if image_data.ndim == 2:
                image_data = image_data[None, ...]
            elif image_data.ndim == 4:
                if image_data.shape[-1] == 1:
                    image_data = image_data[..., 0]
                elif image_data.shape[1] == 1:
                    image_data = image_data[:, 0, ...]
            if self.resize is not None:
                image_data = img_resize(image_data, self.resize)
            image_data = img_pad(image_data, self.downsampling)
            x = torch.from_numpy(format_image(image_data, norm=False))
            with profiling.span("predictor.upload"):
                x = x.to(self.device)
            return self._minmax(x) if norm else x

    def _num_batches(self, n: int, h: int, w: int) -> int:
        # chunks of ~256 MB of activations, never more chunks than frames
        # (`atomai_tpu/predictors/predictor.py:317-327`)
        bytes_total = n * h * w * 4 * max(self.nb_classes, 16)
        return min(max(1, int(np.ceil(bytes_total / (256 * 2 ** 20)))), n)

    def predict_device(self, image_data, return_image: bool = False,
                       **kwargs):
        """NHWC float32 probability maps, left on the device; with
        ``return_image`` also the preprocessed NHWC images."""
        x = self.preprocess(image_data, kwargs.get("norm", True))
        n, h, w = x.shape[:3]
        num_batches = kwargs.get("num_batches") or \
            self._num_batches(n, h, w)
        with profiling.span("predictor.forward"):
            y = self._batch_forward(x.permute(0, 3, 1, 2),
                                    num_batches).float()
            if self.logits:
                y = torch.softmax(y, dim=1) if self.nb_classes > 1 \
                    else torch.sigmoid(y)
            elif self.nb_classes > 1:
                y = torch.exp(y)
            y = y.permute(0, 2, 3, 1).contiguous()
        return (y, x) if return_image else y

    def predict(self, image_data, return_image: bool = False, **kwargs):
        """NHWC float32 probability maps as numpy; with ``return_image``,
        (the preprocessed NHWC images, the maps), images first, as the JAX
        package returns them."""
        if return_image:
            y, x = self.predict_device(image_data, return_image=True,
                                       **kwargs)
            with profiling.span("predictor.fetch"):
                return x.cpu().numpy(), y.cpu().numpy()
        y = self.predict_device(image_data, **kwargs)
        with profiling.span("predictor.fetch"):
            return y.cpu().numpy()

    def run(self, image_data, compute_coords: bool = True, **kwargs):
        """Predict + locate: (NHWC maps as numpy, coordinates dict)."""
        with profiling.span("predictor.run"):
            start_time = time.time()
            if not compute_coords:
                return self.predict(image_data, **kwargs)
            y, x = self.predict_device(image_data, return_image=True, **kwargs)
            thresh = kwargs.get("thresh", self.thresh)
            coordinates = Locator(thresh, refine=self.refine,
                                  d=self.d).run(y, x)
            with profiling.span("predictor.fetch"):
                decoded_imgs = y.cpu().numpy()
            if self.verbose:
                n_images_str = " image was " if decoded_imgs.shape[0] == 1 \
                    else " images were "
                print("\n" + str(decoded_imgs.shape[0]) + n_images_str +
                      "decoded in approximately " +
                      str(np.around(time.time() - start_time, decimals=4)) +
                      " seconds")
            return decoded_imgs, coordinates


class ImSpecPredictor(BasePredictor):
    """im2spec / spec2im predictor (`atomai_tpu/predictors/predictor.py:
    355-401`): ``output_dim`` is (length,) for spectra out, (h, w) for
    images out. Inputs are min-max normalised over the whole set unless
    ``norm=False``; the output comes back as numpy (n, *output_dim)."""

    def __init__(self, model: nn.Module, output_dim, **kwargs):
        super().__init__(model, **kwargs)
        if isinstance(output_dim, int):
            output_dim = (output_dim,)
        if len(output_dim) not in (1, 2):
            raise ValueError("output_dim must be a two-value tuple for "
                             "images and a single-value tuple for spectra")
        self.output_dim = tuple(output_dim)
        self.verbose = kwargs.get("verbose", True)

    def preprocess(self, signal, norm: bool = True) -> torch.Tensor:
        signal = np.asarray(signal)
        if len(self.output_dim) == 1:   # image -> spectrum
            signal = format_image(signal, norm=False)
        else:                            # spectrum -> image
            if signal.ndim == 1:
                signal = signal[None]
            signal = format_spectra(signal)
        x = torch.from_numpy(signal).to(self.device)
        x = self._minmax(x) if norm else x
        return x[..., 0] if len(self.output_dim) == 1 else x

    def predict(self, signal, **kwargs) -> np.ndarray:
        x = self.preprocess(signal, kwargs.get("norm", True))
        y = self.batch_forward(x, kwargs.get("num_batches", 10))
        return y.float().cpu().numpy().reshape((len(x),) + self.output_dim)

    def run(self, signal, **kwargs) -> np.ndarray:
        start_time = time.time()
        prediction = self.predict(signal, **kwargs)
        if self.verbose:
            if len(self.output_dim) == 1:
                str_ = " image was " if prediction.shape[0] == 1 \
                    else " images were "
            else:
                str_ = " spectrum was " if prediction.shape[0] == 1 \
                    else " spectra were "
            print("\n" + str(prediction.shape[0]) + str_ +
                  "decoded in approximately " +
                  str(np.around(time.time() - start_time, decimals=4)) +
                  " seconds")
        return prediction


class RegPredictor(BasePredictor):
    """Regression predictor (counterpart of
    `atomai_tpu/predictors/predictor.py:404-437`): images (N?, H, W[, 1])
    min-max normalised over the whole set unless ``norm=False``, then
    (n, ``output_dim``) values as numpy, squeezed."""

    def __init__(self, model: nn.Module, output_dim: int, **kwargs):
        super().__init__(model, **kwargs)
        self.output_dim = output_dim
        self.verbose = kwargs.get("verbose", True)

    def preprocess(self, image_data, norm: bool = True) -> torch.Tensor:
        """NCHW float32 tensor on the device."""
        x = torch.from_numpy(format_image(image_data, norm=False)).to(
            self.device)
        return (self._minmax(x) if norm else x).permute(0, 3, 1, 2)

    def forward_all(self, image_data, **kwargs) -> np.ndarray:
        x = self.preprocess(image_data, kwargs.get("norm", True))
        y = self.batch_forward(x, kwargs.get("num_batches", 10))
        return y.float().cpu().numpy().reshape(len(x), self.output_dim)

    def predict(self, image_data, **kwargs) -> np.ndarray:
        return self.forward_all(image_data, **kwargs).squeeze()

    def run(self, image_data, **kwargs) -> np.ndarray:
        start_time = time.time()
        prediction = self.predict(image_data, **kwargs)
        if self.verbose:
            n_images = 1 if prediction.ndim == 0 else prediction.shape[0]
            print("\n" + str(n_images) + (" image was " if n_images == 1
                                          else " images were ") +
                  "decoded in approximately " +
                  str(np.around(time.time() - start_time, decimals=4)) +
                  " seconds")
        return prediction


class clsPredictor(RegPredictor):
    """Classification predictor (counterpart of
    `atomai_tpu/predictors/predictor.py:440-452`): the argmax class of each
    image."""

    def __init__(self, model: nn.Module, nb_classes: int, **kwargs):
        super().__init__(model, nb_classes, **kwargs)

    def predict(self, image_data, **kwargs) -> np.ndarray:
        return np.argmax(self.forward_all(image_data, **kwargs), 1).squeeze()


class Locator:
    """NN output -> atomic coordinates.

    All (frame, class) masks of the stack are labelled as one tiled image
    and reduced to centres of mass on the device; only the coordinates are
    copied to the host. A tensor input is labelled on its own device (the
    CUDA kernel for a CUDA tensor); a numpy input is copied to ``device``
    first (default ``"cuda"``, which raises where torch sees no card;
    ``device="cpu"`` labels it with the plain version). With
    ``refine=True`` (keyword args ``refine``, ``d``), ``run`` takes the
    images too and refines every atom by a 2D Gaussian fit on the maps'
    device (:func:`refine_peaks`), all frames in one batch per window size.
    """

    def __init__(self, threshold: float = 0.5, dist_edge: int = 5,
                 dim_order: str = "channel_last",
                 device: Union[str, torch.device] = "cuda", **kwargs):
        self.dim_order = dim_order
        self.threshold = threshold
        self.dist_edge = dist_edge
        self.device = device
        self.refine = kwargs.get("refine")
        self.d = kwargs.get("d")

    def preprocess(self, nn_output: torch.Tensor) -> torch.Tensor:
        """Adds the background channel to one-class output
        (`atomai_tpu/predictors/predictor.py:472-483`)."""
        if nn_output.shape[-1] == 1:
            nn_output = torch.cat((nn_output, 1 - nn_output), dim=3)
        if self.dim_order == "channel_first":
            nn_output = nn_output.permute(0, 2, 3, 1)
        elif self.dim_order != "channel_last":
            raise NotImplementedError(
                'For dim_order, use "channel_first" or "channel_last"')
        return nn_output

    def run(self, nn_output: Union[np.ndarray, torch.Tensor],
            *args: Union[np.ndarray, torch.Tensor]) -> Dict[int, np.ndarray]:
        """Coordinates for every frame: {frame: (n, 3) float64
        [row, col, class]}, classes in channel order. With ``refine``, the
        images (N, H, W[, 1]) follow ``nn_output``."""
        with profiling.span("locator.run"):
            if not isinstance(nn_output, torch.Tensor):
                nn_output = torch.from_numpy(np.asarray(nn_output, np.float32))
                with profiling.span("locator.upload"):
                    nn_output = nn_output.to(resolve_device(self.device))
            if nn_output.shape[-1] == 1 and self.dim_order == "channel_last":
                n_cls = 1  # the background channel preprocess adds is unread
            else:
                nn_output = self.preprocess(nn_output)
                n_cls = nn_output.shape[-1] - 1  # the last is background
            n, h, w = nn_output.shape[:3]
            masks = (nn_output[..., :n_cls] > self.threshold).permute(
                0, 3, 1, 2).reshape(n * n_cls, h, w)
            coords, frames, _ = blob_centers_tiled(masks)
            # one copy to the host: [row, col, mask], masks ascending (frame,
            # then class); each frame's rows are then one slice of the table
            table = torch.cat([coords.double(), frames.double()[:, None]],
                              dim=1)
            with profiling.span("locator.fetch"):
                table = table.cpu()
            table = self.rem_edge_coord(table.numpy(), h, w)
            mask_idx = table[:, 2].astype(np.int64)
            table[:, 2] = mask_idx % n_cls
            bounds = np.searchsorted(mask_idx, np.arange(1, n) * n_cls)
            d_coord = dict(enumerate(np.split(table, bounds)))
            if self.refine:
                if not args:
                    raise AssertionError(
                        "Pass input image(s) for coordinates refinement")
                d_coord = self._refine(d_coord, args[0], nn_output.device)
            return d_coord

    def _refine(self, d_coord: Dict[int, np.ndarray], images,
                device: torch.device) -> Dict[int, np.ndarray]:
        """Refines every frame's atoms in the images on ``device``: one
        :func:`refine_peaks` call for each distinct window half-side."""
        imgs = torch.as_tensor(images, dtype=torch.float32).to(device)
        if imgs.ndim == 4:
            imgs = imgs[..., 0]
        frames = [i for i in d_coord if len(d_coord[i])]
        d_of = {i: int(self.d) if self.d is not None else
                int(mean_nn_distance(d_coord[i]) * 0.25) for i in frames}
        out = dict(d_coord)
        for d in sorted(set(d_of.values())):
            sel = [i for i in frames if d_of[i] == d]
            xy = np.concatenate([d_coord[i][:, :2] for i in sel])
            idx = np.concatenate([np.full(len(d_coord[i]), i) for i in sel])
            refined = refine_peaks(
                imgs, torch.as_tensor(xy, dtype=torch.float32,
                                      device=device), d,
                torch.as_tensor(idx, device=device)).cpu().numpy()
            for i, part in zip(sel, np.split(refined, np.cumsum(
                    [len(d_coord[i]) for i in sel])[:-1])):
                out[i] = np.concatenate([part, d_coord[i][:, 2:3]], axis=1)
        return out

    def rem_edge_coord(self, coordinates: np.ndarray, h: int, w: int
                       ) -> np.ndarray:
        """Drops the rows of a [row, col, ...] table whose blob lies within
        ``dist_edge`` of the (padded) frame's edges
        (`atomai_tpu/predictors/predictor.py:554-563`)."""
        e = self.dist_edge
        row, col = coordinates[:, 0], coordinates[:, 1]
        bad = (row > h - e) | (row < e) | (col > w - e) | (col < e)
        return coordinates[~bad]
