"""Ensemble prediction with uncertainty, and the ensemble's atom positions.

Counterpart of `atomai_tpu/predictors/epredictor.py:26-337`:

- :class:`EnsemblePredictor`: every member's eval-mode forward of each
  chunk, their mean and variance reduced on the device, only those two
  copied to the host. Members are ``state_dict``s (each with its own
  BatchNorm statistics; a member without them takes the skeleton's) taken
  in numeric key order. ``member_layout`` "map" runs the members one after
  another; "vmap" runs them as one ``torch.func.vmap`` of
  ``functional_call`` over their stacked weights
  (``torch.func.stack_module_state``); "auto" takes the one measured
  faster on the card (``AUTO_LAYOUT``). Where the host, not the card,
  sets the pace (:func:`graph_engages`), a chunk's member forwards replay
  from a CUDA graph (``core/graphs.py``), captured at an input
  signature's second sighting;
- :func:`ensemble_locate`: one :class:`Locator` run over every (member,
  frame) map, so that on a CUDA tensor one labeller call serves the whole
  ensemble, then DBSCAN of each frame's coordinates
  (:func:`cluster_coord`).

Segmentation nets take NCHW input and give NCHW output (permuted to and
from the NHWC data); SignalED takes the data as it is.

Members over the model axis (`atomai_tpu/predictors/epredictor.py:88-99,
195-212`): in a world of several ranks ``mesh=None`` spreads the members
over an ``ensemble_mesh`` (``mesh=False``: every rank runs every member; a
``DeviceMesh`` is used as given). A rank builds and forwards its
contiguous block of members, the blocks' outputs are all-gathered over the
model axis, and every rank reduces the mean and variance over all members
as one process does (a rank outside the mesh runs every member).
"""

import collections
import copy
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..core import graphs, profiling
from ..core.mesh import (MODEL_AXIS, block, gather_blocks,
                         resolve_model_mesh, splits)
from ..nets.ed import SignalED
from ..nets.functional_bn import autocast_in_vmap, vmappable
from ..utils.coords import cluster_coord
from ..utils.preproc import format_image, format_spectra
from .predictor import BasePredictor, Locator

# member_layout "auto": the loop, which an H100 80GB HBM3 (700 W) ran
# faster than the vmap on config D's predictor (4 Unets, 32 x 512^2
# frames; chip_smoke.py's ensemble_path): 181-260 ms against 268-281 ms a
# predict with the vmap's convs in bf16 (``autocast_in_vmap``; PERF.md)
AUTO_LAYOUT = "map"
# chunks of at most this many pixels (frames x H x W) replay the members'
# forwards from a CUDA graph: below it the host's launches set the pace,
# above it the card does and a graph only pins memory. Config D's 4
# members on an H100 80GB HBM3 (700 W), eager, 1/2/4/8 frames of 512^2:
# 10.8/12.6/14.3/14.2 ms of host issuing a chunk, 3.9/5.9/10.4/19.5 ms of
# kernels (PERF.md). Both layouts' graphs equal their eager forwards bit
# for bit there (chip_smoke.py's ensemble_graph phase).
GRAPH_MAX_PIXELS = 4 * 512 * 512
# input signatures a predictor remembers (seen once, or graphed); the
# oldest is dropped first, with its graph and memory pool
GRAPHS_KEPT = 4
_COUNTERS = {"eager": "predictor.eager_forward",
             "capture": "predictor.graph_capture",
             "replay": "predictor.graph_replay"}


def graph_engages(device: torch.device, mesh, grad_enabled: bool,
                  pixels: int) -> bool:
    """Whether a chunk of ``pixels`` replays the members' forwards from a
    CUDA graph: on a CUDA device, with no mesh splitting the members over
    ranks (their gather is a collective), autograd off, and at most
    ``GRAPH_MAX_PIXELS``."""
    return (device.type == "cuda" and not splits(mesh, MODEL_AXIS)
            and not grad_enabled and pixels <= GRAPH_MAX_PIXELS)


def _pixels(x: torch.Tensor) -> int:
    """Frames x H x W of a channel-last image chunk; elements otherwise."""
    return x.numel() // x.shape[-1] if x.ndim == 4 else x.numel()


def _member_order(k):
    return int(k) if isinstance(k, str) and k.isdigit() else k


class EnsemblePredictor(BasePredictor):
    """Mean and variance of an ensemble's predictions.

    Example:
        >>> p = aoi.predictors.EnsemblePredictor(net, ensemble,
        ...                                      nb_classes=1)
        >>> mean, var = p.predict(images)

    ``data_type`` and ``output_type`` are "image" or "spectra"; image <->
    spectra needs ``in_dim`` and ``out_dim``. Keyword args: ``logits``
    (default True: sigmoid for one class, softmax for several),
    ``member_layout`` ("auto", "map", "vmap"), ``output_shape``,
    ``verbose``, ``mesh`` (the members' mesh: None for the automatic one,
    False for none, or a ``DeviceMesh``). The predictor runs on the
    skeleton's device.

    Where :func:`graph_engages`, the members' forwards replay from CUDA
    graphs that read the members' parameters and buffers in place:
    ``load_state_dict`` into a member stays correct, while replacing a
    member or its parameter tensors needs a new predictor.
    """

    def __init__(self, skeleton: nn.Module,
                 ensemble: Mapping[Any, Mapping[str, torch.Tensor]],
                 data_type: str = "image", output_type: str = "image",
                 nb_classes: Optional[int] = None,
                 in_dim: Optional[Tuple[int, ...]] = None,
                 out_dim: Optional[Tuple[int, ...]] = None, **kwargs: Any):
        super().__init__(skeleton, **kwargs)
        if output_type not in ("image", "spectra"):
            raise TypeError(
                "Supported output types are 'image' and 'spectra'")
        if [data_type, output_type] in (["image", "spectra"],
                                        ["spectra", "image"]) \
                and not all([in_dim, out_dim]):
            raise TypeError(
                "Specify input (in_dim) & output (out_dim) dimensions")
        layout = kwargs.get("member_layout", "auto")
        if layout == "auto":
            layout = AUTO_LAYOUT
        if layout not in ("map", "vmap"):
            raise ValueError("member_layout must be 'auto'|'map'|'vmap'")
        self.member_layout = layout
        base = skeleton.state_dict()
        keys = sorted(ensemble, key=_member_order)
        self.n_models = len(keys)
        self._mesh = resolve_model_mesh(kwargs.get("mesh", None),
                                        self.n_models)
        self.members = []          # this rank's block of them
        for k in keys[block(self.n_models, self._mesh, MODEL_AXIS)]:
            net = copy.deepcopy(skeleton)
            net.load_state_dict({**base, **ensemble[k]})
            self.members.append(net.eval())
        if layout == "vmap":
            from torch.func import stack_module_state
            params, buffers = stack_module_state(self.members)
            self._stacked = ({k: v.detach() for k, v in params.items()},
                             buffers)
            self._base = vmappable(copy.deepcopy(self.members[0])).to(
                "meta")
        self.data_type = data_type
        self.output_type = output_type
        self.nb_classes = nb_classes
        self.in_dim, self.out_dim = in_dim, out_dim
        self.logits = kwargs.get("logits", True)
        self._channels_first = not isinstance(skeleton, SignalED)
        self._user_output_shape = kwargs.get("output_shape")
        self.output_shape = self._user_output_shape
        verbose = kwargs.get("verbose", 1)
        self.everbose = bool(verbose)
        self.verbose = verbose > 1 if isinstance(verbose, int) else False
        # input signature -> its graphed call
        self._graphs = collections.OrderedDict() \
            if self.device.type == "cuda" else None

    def _set_output_shape(self, data: torch.Tensor) -> None:
        """Output shape, channel-last (`epredictor.py:119-135`)."""
        n = len(data)
        c = self.nb_classes if self.nb_classes else 1
        if self.data_type == self.output_type == "image":
            out_shape = (n, *data.shape[1:3], c)
        elif self.data_type == "spectra" and self.output_type == "image":
            out_shape = (n, *self.out_dim, c)
        elif self.data_type == "image" and self.output_type == "spectra":
            out_shape = (n, *self.out_dim, 1)
        elif self.data_type == self.output_type == "spectra":
            out_shape = (n, data.shape[1], 1)
        else:
            raise TypeError("Data not understood")
        self.output_shape = out_shape

    def preprocess(self, data, norm: bool = True) -> torch.Tensor:
        """Images -> NHWC, spectra -> (n, length), float32 on the device,
        min-max normalised there over the whole set unless ``norm=False``."""
        with profiling.span("predictor.preprocess"):
            data = np.asarray(data)
            if self.data_type == "image":
                data = format_image(data, norm=False)
            else:
                if data.ndim == 1:
                    data = data[None]
                data = format_spectra(data)
            data = torch.from_numpy(data)
            with profiling.span("predictor.upload"):
                x = data.to(self.device)
            return self._minmax(x) if norm else x

    def _member_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """(n_models, n, ...) float32 outputs of a chunk, channel-last,
        after the logits' activation (every rank's block of members);
        replayed from a CUDA graph where :func:`graph_engages`."""
        with profiling.span("predictor.forward"):
            if not graph_engages(self.device, self._mesh,
                                 torch.is_grad_enabled(), _pixels(x)):
                profiling.count("predictor.eager_forward")
                return self._forward(x)
            key = (tuple(x.shape), x.dtype, x.stride(),
                   torch.is_inference_mode_enabled(), self.precision)
            call = self._graphs.get(key)
            if call is None:
                # a private pool, freed with the dropped signature: a
                # replay allocates nothing
                call = self._graphs[key] = graphs.GraphedCall(
                    warmup=1, private=True)
                if len(self._graphs) > GRAPHS_KEPT:
                    self._graphs.popitem(last=False)
            profiling.count(_COUNTERS[call.stage])
            with call.stream(self.device):
                return call(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        image_in = self.data_type == "image" and self._channels_first
        if image_in:
            x = x.permute(0, 3, 1, 2)
        with self.precision.scope(self.device):
            if self.member_layout == "vmap":
                from torch.func import functional_call, vmap
                with autocast_in_vmap():
                    out = vmap(lambda p, b, xx: functional_call(
                        self._base, (p, b), (xx,)),
                        in_dims=(0, 0, None))(*self._stacked, x)
            else:
                out = torch.stack([m(x) for m in self.members])
        out = gather_blocks(out.float(), self._mesh, MODEL_AXIS)
        if self._channels_first and out.ndim == 5:
            out = out.permute(0, 1, 3, 4, 2)
        nb = self.nb_classes or 0
        if self.logits:
            if nb > 1:
                out = torch.softmax(out, dim=-1)
            elif nb == 1:
                out = torch.sigmoid(out)
        elif nb > 1:
            out = torch.exp(out)
        return out

    @torch.inference_mode()
    def ensemble_forward(self, data, out_shape=None, num_batches: int = 1
                         ) -> np.ndarray:
        """Every member's prediction of ``data`` (preprocessed input), as
        numpy (n_models, n, ...), reshaped per member to ``out_shape`` when
        given."""
        with profiling.span("predictor.ensemble_forward"):
            x = torch.as_tensor(data).to(self.device)
            bsz = max(1, len(x) // max(1, num_batches))
            preds = torch.cat([self._member_outputs(x[s:s + bsz])
                               for s in range(0, len(x), bsz)], dim=1)
            with profiling.span("predictor.fetch"):
                preds = preds.cpu().numpy()
            if preds.ndim == 3:
                preds = preds[..., None]
            if out_shape is not None:
                preds = preds.reshape((self.n_models, *out_shape))
            return preds

    def ensemble_forward_(self, data, out_shape=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Mean and variance over the members of :meth:`ensemble_forward`
        (population variance, as numpy's)."""
        eprediction = self.ensemble_forward(data, out_shape)
        return np.mean(eprediction, axis=0), np.var(eprediction, axis=0)

    @torch.inference_mode()
    def ensemble_batch_predict(self, data: torch.Tensor,
                               num_batches: int = 10
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Mean and variance over the members, chunk by chunk
        (``num_batches`` chunks and a remainder), reduced on the device;
        one copy of each to the host."""
        batch_size = len(data) // num_batches
        if batch_size < 1:
            num_batches, batch_size = 1, len(data)
        chunks = [data[i * batch_size:(i + 1) * batch_size]
                  for i in range(num_batches)]
        if num_batches * batch_size < len(data):
            chunks.append(data[num_batches * batch_size:])
        means, variances = [], []
        for i, chunk in enumerate(chunks):
            if self.everbose:
                print("\rBatch {}/{}".format(i + 1, len(chunks)), end="")
            preds = self._member_outputs(chunk)
            means.append(preds.mean(0))
            variances.append(preds.var(0, unbiased=False))
        mean, var = torch.cat(means), torch.cat(variances)
        with profiling.span("predictor.fetch"):
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
        return (mean.reshape(self.output_shape),
                var.reshape(self.output_shape))

    def predict(self, data, num_batches: int = 10,
                format_out: str = "channel_last", norm: bool = True
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, variance) of the members' predictions, as numpy."""
        if format_out not in ("channel_first", "channel_last"):
            raise ValueError(
                "Specify channel_last or channel_first output format")
        with profiling.span("predictor.predict"):
            data = self.preprocess(data, norm)
            if self._user_output_shape:
                self.output_shape = self._user_output_shape
            else:
                self._set_output_shape(data)
            mean, var = self.ensemble_batch_predict(data, num_batches)
            if format_out == "channel_first":
                axes = (0, mean.ndim - 1, *range(1, mean.ndim - 1))
                mean, var = mean.transpose(axes), var.transpose(axes)
            return mean, var


def ensemble_locate(nn_output_ensemble: Union[np.ndarray, torch.Tensor],
                    **kwargs: Any) -> Tuple[Dict, Dict]:
    """Atom positions of an ensemble's maps (n_models, n_images, H, W, C):
    ({frame: (k, 2) cluster means}, {frame: (k, 2) cluster variances}).

    All n_models * n_images maps go through one :class:`Locator` run (on a
    CUDA tensor, one labeller call); each frame's coordinates of every
    member are then clustered by DBSCAN. Keyword args: ``eps`` (0.5),
    ``threshold`` (0.5), ``min_samples`` (10: an atom needs that many
    member detections), ``device`` for numpy input ("cuda", the default,
    raises without a card; "cpu" when asked for)."""
    eps = kwargs.get("eps", 0.5)
    thresh = kwargs.get("threshold", 0.5)
    min_samples = kwargs.get("min_samples", 10)
    n_models, n_images = nn_output_ensemble.shape[:2]
    with profiling.span("locator.ensemble_locate"):
        flat = nn_output_ensemble.reshape(
            (n_models * n_images,) + tuple(nn_output_ensemble.shape[2:]))
        all_coords = Locator(thresh,
                             device=kwargs.get("device", "cuda")).run(flat)
        coord_mean_all, coord_var_all = {}, {}
        for i in range(n_images):
            coordinates = {m: all_coords[m * n_images + i]
                           for m in range(n_models)}
            _, coord_mean, coord_var = cluster_coord(coordinates, eps,
                                                     min_samples)
            coord_mean_all[i] = coord_mean
            coord_var_all[i] = coord_var
    return coord_mean_all, coord_var_all
