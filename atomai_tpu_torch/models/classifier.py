"""Classifier — the user-facing image classification model.

Counterpart of `atomai_tpu/models/classifier.py`: a :class:`clsTrainer`
with ``fit`` (compile + on-device intensity augmentation + run),
``predict`` (:class:`clsPredictor`) and ``load_weights``, and the
reference's argument order with the legacy one beside it. The net is built
and its weights drawn from ``seed`` at construction.
"""

from typing import Any

from ..predictors import clsPredictor
from ..trainers import clsTrainer
from ..transforms import reg_augmentor
from .conversion import reg_cls_from_jax
from .regressor import backbone_args


class Classifier(clsTrainer):
    """Image classification.

    Example:
        >>> m = aoi.models.Classifier("resnet", nb_classes=3, device="cuda")
        >>> m.fit(imgs, labels, imgs_t, labels_t, training_cycles=50)
        >>> predicted_classes = m.predict(imgs_new)

    Keyword args as :class:`~atomai_tpu_torch.models.Regressor`'s.
    """

    jax_bridge = staticmethod(reg_cls_from_jax)

    def __init__(self, model: str = "mobilenet", nb_classes: int = None,
                 **kwargs: Any) -> None:
        model, nb_classes = backbone_args(
            model, nb_classes, "a number of classes (nb_classes)", kwargs)
        super().__init__(nb_classes, model, **kwargs)

    def fit(self, X_train, y_train, X_test=None, y_test=None,
            loss: str = "nll", optimizer=None, training_cycles: int = 1000,
            batch_size: int = 32, compute_accuracy: bool = True,
            full_epoch: bool = False, swa: bool = False,
            perturb_weights: bool = False, **kwargs: Any) -> None:
        """Compiles the trainer and trains (accuracy on by default)."""
        self.compile_trainer(
            (X_train, y_train, X_test, y_test), loss, optimizer,
            training_cycles, batch_size, compute_accuracy, full_epoch,
            swa, perturb_weights, **kwargs)
        self.augment_fn = reg_augmentor(**kwargs)
        self.run()

    def predict(self, data, **kwargs):
        """The argmax class of each image, as numpy, squeezed."""
        return clsPredictor(self.net, self.nb_classes,
                            **kwargs).run(data, **kwargs)
