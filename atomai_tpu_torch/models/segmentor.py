"""Segmentor — the user-facing segmentation model.

Counterpart of `atomai_tpu/models/segmentor.py:17-64`: a
:class:`SegTrainer` with ``fit`` (compile + on-device augmentation + run),
``predict`` (SegPredictor and Locator) and ``load_weights``. The net is
built and its weights drawn from ``seed`` at construction, from the
torch-default distribution the JAX package imitates (``AOI_TORCH_INIT``);
the JAX Segmentor draws them when ``fit`` compiles.
"""

from typing import Any, Mapping, Optional, Tuple

from ..core.checkpoint import load_checkpoint
from ..predictors import SegPredictor
from ..trainers import SegTrainer
from ..transforms import seg_augmentor
from .conversion import unet_from_jax


class Segmentor(SegTrainer):
    """Semantic segmentation of images into atoms and their coordinates.

    Example:
        >>> m = aoi.models.Segmentor("Unet", nb_classes=1, device="cuda")
        >>> m.fit(imgs, masks, training_cycles=300, batch_size=32)
        >>> nn_output, coordinates = m.predict(imgs, refine=True, d=4)

    Keyword args: ``seed`` (weights, batch order and every random draw of
    ``fit``; default 1), ``batch_seed``, ``device`` ("cuda", the default,
    needs a card and raises without one; "cpu" when asked for), and the net's ``nb_filters``,
    ``layers``, ``batch_norm``, ``dropout``, ``upsampling``.
    """

    def fit(self, X_train, y_train, X_test=None, y_test=None,
            loss: str = "ce", optimizer=None, training_cycles: int = 1000,
            batch_size: int = 32, compute_accuracy: bool = False,
            full_epoch: bool = False, swa: bool = False,
            perturb_weights: bool = False, **kwargs: Any) -> None:
        """Compiles the trainer and trains. Augmentation kwargs
        (``rotation=True``, ``gauss_noise=[20, 60]``, ``zoom=True``, ...)
        run on the device inside each train step; without them the batches
        go to the net as they are."""
        self.compile_trainer(
            (X_train, y_train, X_test, y_test), loss, optimizer,
            training_cycles, batch_size, compute_accuracy, full_epoch,
            swa, perturb_weights, **kwargs)
        self.augment_fn = seg_augmentor(self.nb_classes, **kwargs)
        self.run()

    def predict(self, imgdata, refine: bool = False, logits: bool = True,
                resize: Optional[Tuple[int, int]] = None,
                compute_coords: bool = True, **kwargs):
        """NHWC probability maps (numpy) and, with ``compute_coords``, the
        coordinates dict ``{frame: (n, 3) [row, col, class]}``; with
        ``refine`` (and the window half-side ``d``) the coordinates are
        refined by 2D Gaussian fits on the device."""
        return SegPredictor(
            self.net, refine, resize, logits, nb_classes=self.nb_classes,
            **kwargs).run(imgdata, compute_coords, **kwargs)

    def load_weights(self, filepath: str) -> None:
        """Loads the weights of a ``.aoit`` file written by
        :meth:`save_model`."""
        _, arrays = load_checkpoint(filepath)
        self.net.load_state_dict(arrays["params"])

    def load_jax_variables(self, params: Mapping[str, Any],
                           batch_stats: Optional[Mapping[str, Any]] = None
                           ) -> None:
        """Loads a JAX Unet's variables (nested dicts of numpy arrays);
        afterwards both packages compute the same function."""
        state = unet_from_jax(params, batch_stats,
                              dropout=self.meta_state_dict.get("dropout",
                                                               False))
        self.net.load_state_dict(state, strict=True)
