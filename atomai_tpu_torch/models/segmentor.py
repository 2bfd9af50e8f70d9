"""Segmentor — the user-facing segmentation model (serving half).

Counterpart of `atomai_tpu/models/segmentor.py:17-64` and the net set-up
of `atomai_tpu/trainers/trainer.py:837-848`. The net is built and its
weights drawn from ``seed`` at construction (the JAX Segmentor holds no
weights before ``fit``). ``fit`` arrives with the port's ``SegTrainer``.
"""

from typing import Any, Mapping, Optional, Tuple

import torch

from ..core.prng import generator_from_seed
from ..nets import init_fcnn_model, init_weights_
from ..predictors import SegPredictor
from .conversion import unet_from_jax


class Segmentor:
    """Semantic segmentation of images into atoms and their coordinates.

    Example:
        >>> m = aoi.models.Segmentor("Unet", nb_classes=1, seed=1,
        ...                          device="cuda")
        >>> nn_output, coordinates = m.predict(imgs)

    Keyword args: ``seed`` (weights, default 1), ``device`` (default
    "cpu"; "cuda" needs a card and raises without one), and the net's
    ``nb_filters``, ``layers``, ``batch_norm``, ``dropout``,
    ``upsampling``.
    """

    def __init__(self, model: str = "Unet", nb_classes: int = 1,
                 **kwargs: Any) -> None:
        self.device = torch.device(kwargs.get("device", "cpu"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but torch "
                               "sees no CUDA device")
        self.nb_classes = nb_classes
        self.net, self.meta_state_dict = init_fcnn_model(
            model, nb_classes, **kwargs)
        init_weights_(self.net, generator_from_seed(kwargs.get("seed", 1)))
        self.net.to(self.device).eval()

    def predict(self, imgdata, refine: bool = False, logits: bool = True,
                resize: Optional[Tuple[int, int]] = None,
                compute_coords: bool = True, **kwargs):
        """NHWC probability maps (numpy) and, with ``compute_coords``, the
        coordinates dict ``{frame: (n, 3) [row, col, class]}``."""
        return SegPredictor(
            self.net, refine, resize, logits, nb_classes=self.nb_classes,
            **kwargs).run(imgdata, compute_coords, **kwargs)

    def load_jax_variables(self, params: Mapping[str, Any],
                           batch_stats: Optional[Mapping[str, Any]] = None
                           ) -> None:
        """Loads a JAX Unet's variables (nested dicts of numpy arrays);
        afterwards both packages compute the same function."""
        state = unet_from_jax(params, batch_stats,
                              dropout=self.meta_state_dict.get("dropout",
                                                               False))
        self.net.load_state_dict(state, strict=True)
