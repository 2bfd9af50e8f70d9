"""Regressor — the user-facing image -> vector regression model.

Counterpart of `atomai_tpu/models/regressor.py`: a :class:`RegTrainer`
with ``fit`` (compile + on-device intensity augmentation + run),
``predict`` (:class:`RegPredictor`) and ``load_weights``. The backbones
are the torchvision topologies ("mobilenet", "resnet", "vgg", randomly
initialised) or the ``*-slim`` conv stacks. The net is built and its
weights drawn from ``seed`` at construction; the JAX Regressor draws them
when ``fit`` compiles.
"""

from typing import Any

from ..predictors import RegPredictor
from ..trainers import RegTrainer
from ..transforms import reg_augmentor
from .conversion import reg_cls_from_jax


def backbone_args(model, count, count_name: str, kwargs):
    """(backbone, count) from the reference's argument order
    ``(model, count)``, the legacy ``(count, backbone)`` one, or the
    ``backbone=`` keyword (`atomai_tpu/models/classifier.py:26-39`)."""
    if isinstance(model, int):
        backbone = count if isinstance(count, str) \
            else kwargs.pop("backbone", "mobilenet")
        model, count = backbone, model
    model = kwargs.pop("backbone", model)
    if count is None:
        raise AssertionError(
            f"You must specify {count_name} for your model")
    return model, count


class Regressor(RegTrainer):
    """Image-based regression.

    Example:
        >>> m = aoi.models.Regressor("mobilenet", out_dim=1, device="cuda")
        >>> m.fit(imgs, values, imgs_t, values_t, training_cycles=50)
        >>> prediction = m.predict(imgs_new)

    Keyword args: ``seed`` (weights, batch order and every random draw of
    ``fit``; default 1), ``batch_seed``, ``device`` ("cuda", the default,
    needs a card and raises without one; "cpu" when asked for),
    ``input_channels`` (default 1), ``backbone``.
    """

    jax_bridge = staticmethod(reg_cls_from_jax)

    def __init__(self, model: str = "mobilenet", out_dim: int = 1,
                 **kwargs: Any) -> None:
        model, out_dim = backbone_args(model, out_dim, "out_dim", kwargs)
        super().__init__(out_dim, model, **kwargs)

    def fit(self, X_train, y_train, X_test=None, y_test=None,
            loss: str = "mse", optimizer=None, training_cycles: int = 1000,
            batch_size: int = 32, compute_accuracy: bool = False,
            full_epoch: bool = False, swa: bool = False,
            perturb_weights: bool = False, **kwargs: Any) -> None:
        """Compiles the trainer and trains. Intensity augmentation kwargs
        (``gauss_noise``, ``blur``, ``contrast``, ...) run on the device
        inside each train step."""
        self.compile_trainer(
            (X_train, y_train, X_test, y_test), loss, optimizer,
            training_cycles, batch_size, compute_accuracy, full_epoch,
            swa, perturb_weights, **kwargs)
        self.augment_fn = reg_augmentor(**kwargs)
        self.run()

    def predict(self, data, **kwargs):
        """Values of images (N?, H, W[, 1]) as numpy, squeezed; ``norm``
        (default True) min-max normalises the inputs."""
        return RegPredictor(self.net, self.out_dim,
                            **kwargs).run(data, **kwargs)
