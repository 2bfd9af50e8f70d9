"""DenoisingAutoencoder — noisy images in, clean images out.

Counterpart of `atomai_tpu/models/denoiser.py:21-165`: the conv
encoder/decoder ``DenoiserNet`` (nearest upsampling and no BatchNorm by
default), ``preprocess_denoiser_data``, the facade with ``fit`` /
``predict`` / ``load_weights``, ``init_denoising_autoencoder`` and
``denoise_images``. The net is built and its weights drawn from ``seed``
at construction; the JAX model draws them when ``fit`` compiles.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.dtypes import head_f32
from ..core.prng import generator_from_seed
from ..nets.blocks import ConvBlock, UpsampleBlock, init_weights_, max_pool
from ..predictors import BasePredictor
from ..trainers import BaseTrainer
from ..utils import preproc
from ..utils.preproc import preprocess_denoiser_data
from .conversion import denoiser_from_jax


class DenoiserNet(nn.Module):
    """Conv encoder (a max pool after every block but the last) and
    decoder (an upsampling block before every block but the first), then a
    1x1 head to one channel in float32. NCHW in and out."""

    def __init__(self, encoder_filters: Sequence[int] = (8, 16, 32, 64),
                 decoder_filters: Sequence[int] = (64, 32, 16, 8),
                 encoder_layers: Sequence[int] = (1, 2, 2, 2),
                 decoder_layers: Sequence[int] = (2, 2, 2, 1),
                 use_batch_norm: bool = False,
                 upsampling_mode: str = "nearest"):
        super().__init__()
        bn = dict(batch_norm=use_batch_norm)
        cin, enc = 1, []
        for filters, layers in zip(encoder_filters, encoder_layers):
            enc.append(ConvBlock(2, layers, cin, filters, **bn))
            cin = filters
        dec, up = [], []
        for i, (filters, layers) in enumerate(zip(decoder_filters,
                                                  decoder_layers)):
            if i > 0:
                up.append(UpsampleBlock(2, cin, cin, mode=upsampling_mode))
            dec.append(ConvBlock(2, layers, cin, filters, **bn))
            cin = filters
        self.encoder = nn.ModuleList(enc)
        self.upsample = nn.ModuleList(up)
        self.decoder = nn.ModuleList(dec)
        self.out = nn.Conv2d(cin, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.encoder):
            x = block(x)
            if i < len(self.encoder) - 1:
                x = max_pool(x)
        for i, block in enumerate(self.decoder):
            if i > 0:
                x = self.upsample[i - 1](x)
            x = block(x)
        return head_f32(self.out, x)


def _net_and_meta(encoder_filters=(8, 16, 32, 64),
                  decoder_filters=(64, 32, 16, 8),
                  encoder_layers=(1, 2, 2, 2), decoder_layers=(2, 2, 2, 1),
                  use_batch_norm=False, upsampling_mode="nearest",
                  **kwargs) -> Tuple[DenoiserNet, Dict[str, Any]]:
    net = DenoiserNet(encoder_filters, decoder_filters, encoder_layers,
                      decoder_layers, use_batch_norm, upsampling_mode)
    return net, {
        "model_type": "denoising_autoencoder",
        "encoder_filters": list(encoder_filters),
        "decoder_filters": list(decoder_filters),
        "encoder_layers": list(encoder_layers),
        "decoder_layers": list(decoder_layers),
        "use_batch_norm": use_batch_norm,
        "upsampling_mode": upsampling_mode}


class DenoisingAutoencoder(BaseTrainer):
    """Denoising autoencoder.

    Example:
        >>> m = aoi.models.DenoisingAutoencoder(device="cuda")
        >>> m.fit(noisy, clean, noisy_t, clean_t, training_cycles=500)
        >>> cleaned = m.predict(new_noisy_images)

    Keyword args: the net's filters, layers, ``use_batch_norm`` and
    ``upsampling_mode``; ``seed`` (weights, batch order; default 1),
    ``batch_seed``, ``device`` ("cuda", the default, needs a card and
    raises without one; "cpu" when asked for).
    """

    jax_bridge = staticmethod(denoiser_from_jax)

    def __init__(self, encoder_filters: List[int] = (8, 16, 32, 64),
                 decoder_filters: List[int] = (64, 32, 16, 8),
                 encoder_layers: List[int] = (1, 2, 2, 2),
                 decoder_layers: List[int] = (2, 2, 2, 1),
                 use_batch_norm: bool = False,
                 upsampling_mode: str = "nearest", **kwargs: Any) -> None:
        seed = kwargs.get("seed", 1)
        super().__init__(seed=seed, device=kwargs.get("device", "cuda"))
        self.batch_seed = kwargs.get("batch_seed", seed)
        self.net, self.meta_state_dict = _net_and_meta(
            encoder_filters, decoder_filters, encoder_layers,
            decoder_layers, use_batch_norm, upsampling_mode)
        init_weights_(self.net, generator_from_seed(seed))
        self.net.to(self.device).eval()

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        self._stage_batches(*preprocess_denoiser_data(
            X_train, y_train, X_test, y_test))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """NHWC batch -> NHWC float32 images."""
        with self.precision.scope(self.device):
            out = self.net(X.permute(0, 3, 1, 2))
        return out.float().permute(0, 2, 3, 1)

    def fit(self, X_train, y_train, X_test=None, y_test=None,
            loss: str = "mse", optimizer=None, training_cycles: int = 500,
            batch_size: int = 32, compute_accuracy: bool = False,
            full_epoch: bool = False, swa: bool = True,
            perturb_weights: bool = False, **kwargs: Any) -> None:
        """Compiles the trainer and trains (SWA on by default, as in the
        JAX package)."""
        self.compile_trainer(
            (X_train, y_train, X_test, y_test), loss, optimizer,
            training_cycles, batch_size, compute_accuracy, full_epoch,
            swa, perturb_weights, **kwargs)
        self.run()

    def predict(self, data, **kwargs) -> np.ndarray:
        """Denoised images as numpy, squeezed; the inputs go to the net as
        they are (no normalisation), in ``num_batches`` (default 10)
        chunks."""
        data = np.asarray(data, np.float32)
        data = data[None, ..., None] if data.ndim == 2 \
            else preproc.as_channel_last_images(data)
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        y = BasePredictor(self.net, **kwargs).batch_forward(
            x.permute(0, 3, 1, 2), kwargs.get("num_batches", 10))
        return y.float().permute(0, 2, 3, 1).cpu().numpy().squeeze()


def init_denoising_autoencoder(**kwargs: Any
                               ) -> Tuple[DenoiserNet, Dict[str, Any]]:
    """(net, metadict) of a denoiser with the given widths; the net on the
    host with its weights drawn from ``seed`` (default 1)."""
    net, meta = _net_and_meta(**kwargs)
    init_weights_(net, generator_from_seed(kwargs.get("seed", 1)))
    return net, meta


def denoise_images(noisy_images: np.ndarray, clean_images: np.ndarray,
                   test_noisy: Optional[np.ndarray] = None,
                   test_clean: Optional[np.ndarray] = None,
                   training_cycles: int = 500, **kwargs: Any
                   ) -> Tuple[DenoisingAutoencoder, Optional[np.ndarray]]:
    """Trains a denoiser (kwargs go to the constructor and to ``fit``) and,
    given ``test_noisy``, denoises it: (model, predictions or None)."""
    model = DenoisingAutoencoder(**kwargs)
    model.fit(noisy_images, clean_images, test_noisy, test_clean,
              training_cycles=training_cycles, **kwargs)
    predictions = None
    if test_noisy is not None:
        predictions = model.predict(test_noisy)
    return model, predictions
