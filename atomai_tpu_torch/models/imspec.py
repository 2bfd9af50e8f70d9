"""ImSpec — the user-facing image <-> spectrum translation model.

Counterpart of `atomai_tpu/models/imspec.py:15-56`: an
:class:`ImSpecTrainer` with ``fit`` (compile + on-device augmentation +
run), ``predict`` (:class:`ImSpecPredictor`), ``save_model`` and
``load_weights``. The net is built and its weights drawn from ``seed`` at
construction; the JAX ImSpec draws them when ``fit`` compiles.
"""

from typing import Any, Tuple

from ..predictors import ImSpecPredictor
from ..trainers import ImSpecTrainer
from ..transforms import imspec_augmentor
from .conversion import signal_ed_from_jax


class ImSpec(ImSpecTrainer):
    """Predicts spectra from images and vice versa.

    Example:
        >>> m = aoi.models.ImSpec((16, 16), (64,), latent_dim=10,
        ...                       device="cuda")
        >>> m.fit(imgs, spectra, imgs_t, spectra_t, full_epoch=True,
        ...       training_cycles=120, swa=True)
        >>> prediction = m.predict(imgs_test, norm=False)

    Keyword args: ``seed`` (weights, batch order and every random draw of
    ``fit``; default 1), ``batch_seed``, ``device`` ("cuda", the default,
    needs a card and raises without one; "cpu" when asked for), and the
    net's ``nblayers_encoder``, ``nblayers_decoder``, ``nbfilters_encoder``,
    ``nbfilters_decoder``, ``batch_norm``, ``encoder_downsampling``,
    ``decoder_upsampling``.
    """

    jax_bridge = staticmethod(signal_ed_from_jax)

    def __init__(self, in_dim: Tuple[int, ...], out_dim: Tuple[int, ...],
                 latent_dim: int = 2, **kwargs: Any) -> None:
        super().__init__(in_dim, out_dim, latent_dim, **kwargs)
        self.latent_dim = latent_dim

    def fit(self, X_train, y_train, X_test=None, y_test=None,
            loss: str = "mse", optimizer=None, training_cycles: int = 1000,
            batch_size: int = 64, compute_accuracy: bool = False,
            full_epoch: bool = False, swa: bool = False,
            perturb_weights: bool = False, **kwargs: Any) -> None:
        """Compiles the trainer and trains. Augmentation kwargs of the
        images (``gauss_noise``, ``blur``, ``contrast``, ...) run on the
        device inside each train step."""
        self.compile_trainer(
            (X_train, y_train, X_test, y_test), loss, optimizer,
            training_cycles, batch_size, compute_accuracy, full_epoch,
            swa, perturb_weights, **kwargs)
        self.augment_fn = imspec_augmentor(self.in_dim, self.out_dim,
                                           **kwargs)
        self.run()

    def predict(self, data, **kwargs):
        """Spectra of images or images of spectra, as numpy
        (n, *out_dim); ``norm`` (default True) min-max normalises the
        inputs, ``num_batches`` (default 10) chunks them."""
        return ImSpecPredictor(self.net, self.out_dim,
                               **kwargs).run(data, **kwargs)
