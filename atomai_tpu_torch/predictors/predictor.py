"""Inference and post-processing to atomic coordinates.

Counterpart of `atomai_tpu/predictors/predictor.py:57-352, 455-563`:

- :class:`BasePredictor`: eval-mode forward in chunks, under the device's
  precision policy;
- :class:`SegPredictor`: preprocess (channel fix-ups, optional resize, pad
  bottom/right to the net's downsample factor, min-max normalise over the
  whole stack), forward, sigmoid/softmax; NHWC maps out;
- :class:`Locator`: background channel for one-class output, threshold,
  connected-component labels and centres of mass for all frames at once,
  edge removal. Output: ``{frame: (n, 3) [row, col, class]}``.

``SegPredictor.run`` keeps the maps on the device: thresholds, labels and
moments are taken there, and only the coordinates and the NHWC maps that
the caller gets back are copied to the host. Not ported: the JAX package's
reduced-precision ``fetch_dtype`` wire and device mesh.
"""

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..core.dtypes import default_precision
from ..nets.fcnn import DOWNSAMPLE_FACTORS
from ..ops.cc_label import blob_centers_tiled
from ..utils.img import img_pad, img_resize
from ..utils.preproc import format_image

_REFINE_NOT_PORTED = ("refine=True is not ported yet: peak refinement is "
                      "ROADMAP Queue 1 #8")


class BasePredictor:
    """Eval-mode forward of ``model`` in chunks, on the model's device,
    under that device's precision policy. Keyword arg: ``verbose``."""

    def __init__(self, model: nn.Module, **kwargs):
        self.model = model
        self.device = next(model.parameters()).device
        self.precision = default_precision(self.device)
        self.verbose = kwargs.get("verbose", False)

    def forward_(self, x: torch.Tensor) -> torch.Tensor:
        """One forward pass of an NCHW batch."""
        with self.precision.scope(self.device):
            return self.model(x)

    def batch_forward(self, x: torch.Tensor, num_batches: int
                      ) -> torch.Tensor:
        """Forward of ``x`` in ``num_batches`` chunks plus a remainder
        chunk (`atomai_tpu/predictors/predictor.py:194-219`); the result
        stays on the device."""
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


class SegPredictor(BasePredictor):
    """Segmentation predictor: NHWC probability maps of an NCHW net.

    Keyword args besides :class:`BasePredictor`'s: ``nb_classes``,
    ``downsampling`` (default from the net's class), ``thresh`` (0.5),
    ``num_batches``, ``norm``.
    """

    def __init__(self, model: nn.Module, refine: bool = False,
                 resize: Optional[Tuple[int, int]] = None,
                 logits: bool = True, **kwargs):
        if refine:
            raise NotImplementedError(_REFINE_NOT_PORTED)
        super().__init__(model, **kwargs)
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
        x = torch.from_numpy(format_image(image_data, norm=False)).to(
            self.device)
        if norm:
            lo = x.min()
            x = (x - lo) / torch.clamp(x.max() - lo, min=1e-12)
        return x

    def _num_batches(self, n: int, h: int, w: int) -> int:
        # chunks of ~256 MB of activations, never more chunks than frames
        # (`atomai_tpu/predictors/predictor.py:317-327`)
        bytes_total = n * h * w * 4 * max(self.nb_classes, 16)
        return min(max(1, int(np.ceil(bytes_total / (256 * 2 ** 20)))), n)

    def predict_device(self, image_data, **kwargs) -> torch.Tensor:
        """NHWC float32 probability maps, left on the device."""
        x = self.preprocess(image_data, kwargs.get("norm", True))
        n, h, w = x.shape[:3]
        num_batches = kwargs.get("num_batches") or \
            self._num_batches(n, h, w)
        y = self.batch_forward(x.permute(0, 3, 1, 2), num_batches).float()
        if self.logits:
            y = torch.softmax(y, dim=1) if self.nb_classes > 1 \
                else torch.sigmoid(y)
        elif self.nb_classes > 1:
            y = torch.exp(y)
        return y.permute(0, 2, 3, 1).contiguous()

    def predict(self, image_data, **kwargs) -> np.ndarray:
        """NHWC float32 probability maps as numpy."""
        return self.predict_device(image_data, **kwargs).cpu().numpy()

    def run(self, image_data, compute_coords: bool = True, **kwargs):
        """Predict + locate: (NHWC maps as numpy, coordinates dict)."""
        start_time = time.time()
        if not compute_coords:
            return self.predict(image_data, **kwargs)
        y = self.predict_device(image_data, **kwargs)
        thresh = kwargs.get("thresh", self.thresh)
        coordinates = Locator(thresh).run(y)
        decoded_imgs = y.cpu().numpy()
        if self.verbose:
            n_images_str = " image was " if decoded_imgs.shape[0] == 1 \
                else " images were "
            print("\n" + str(decoded_imgs.shape[0]) + n_images_str +
                  "decoded in approximately " +
                  str(np.around(time.time() - start_time, decimals=4)) +
                  " seconds")
        return decoded_imgs, coordinates


class Locator:
    """NN output -> atomic coordinates.

    All (frame, class) masks of the stack are labelled as one tiled image
    and reduced to centres of mass on the device; only the coordinates are
    copied to the host. A tensor input is labelled on its device (the CUDA
    kernel for a CUDA tensor); a numpy input is labelled on the CPU.
    """

    def __init__(self, threshold: float = 0.5, dist_edge: int = 5,
                 dim_order: str = "channel_last", **kwargs):
        if kwargs.get("refine"):
            raise NotImplementedError(_REFINE_NOT_PORTED)
        self.dim_order = dim_order
        self.threshold = threshold
        self.dist_edge = dist_edge

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

    def run(self, nn_output: Union[np.ndarray, torch.Tensor]
            ) -> Dict[int, np.ndarray]:
        """Coordinates for every frame: {frame: (n, 3) float64
        [row, col, class]}, classes in channel order."""
        if not isinstance(nn_output, torch.Tensor):
            nn_output = torch.from_numpy(np.asarray(nn_output, np.float32))
        nn_output = self.preprocess(nn_output)
        n, h, w, c = nn_output.shape
        n_cls = c - 1  # the last channel is background
        masks = (nn_output[..., :n_cls] > self.threshold).permute(
            0, 3, 1, 2).reshape(n * n_cls, h, w)
        coords, frames, _ = blob_centers_tiled(masks)
        coords, frames = self._rem_edge(coords, frames, h, w)
        counts = torch.bincount(frames, minlength=n * n_cls).cpu().numpy()
        coords = coords.cpu().numpy().astype(np.float64)
        per_mask = np.split(coords, np.cumsum(counts)[:-1])
        d_coord = {}
        for i in range(n):
            parts = [np.concatenate(
                [per_mask[i * n_cls + ch],
                 np.full((len(per_mask[i * n_cls + ch]), 1), float(ch))],
                axis=1) for ch in range(n_cls)]
            d_coord[i] = np.concatenate(parts, axis=0)
        return d_coord

    def _rem_edge(self, coords: torch.Tensor, frames: torch.Tensor, h: int,
                  w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Drops blobs within ``dist_edge`` of the (padded) frame's edges
        (`atomai_tpu/predictors/predictor.py:554-563`)."""
        e = self.dist_edge
        bad = ((coords[:, 0] > h - e) | (coords[:, 0] < e) |
               (coords[:, 1] > w - e) | (coords[:, 1] < e))
        return coords[~bad], frames[~bad]
