"""BaseVAE and the standard VAE.

Counterpart of `atomai_tpu/models/dgm/vae.py:51-508`: encode / decode /
reconstruct in batches, the 2D manifold (as an array, without plotting),
input checks, the epoch loop of ``fit`` with a per-epoch checkpoint, and
the VAE's class-conditional ELBO (one-hot labels concatenated to z).
``encode_images``, ``encode_trajectories`` and ``manifold_traversal`` are
not ported yet (ROADMAP Queue 1 #13).
"""

from copy import deepcopy as dc
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...core.checkpoint import flush_async_checkpoints
from ...core.mlog import open_metrics_log
from ...losses_metrics.vi_losses import vae_loss
from ...nets.ed import init_VAE_nets
from ...trainers.vitrainer import viBaseTrainer
from ...utils.coords import imcoordgrid
from ...utils.preproc import to_onehot
from ..conversion import vae_from_jax


def norm_ppf(q: np.ndarray) -> np.ndarray:
    """Standard normal percent-point function."""
    from scipy.stats import norm
    return norm.ppf(q)


class BaseVAE(viBaseTrainer):
    """General class for VAE models.

    Keyword args besides the nets' (``numlayers_encoder``,
    ``numhidden_decoder``, ...): ``device`` (default "cpu"; "cuda" needs a
    card and raises without one). ``seed`` gives the weights and every
    random draw of ``fit``, as in the JAX package (``max(seed, 0) + 1``
    seeds the stream).
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 nb_classes: int = 0, coord: int = 0,
                 discrete_dim: Optional[List[int]] = None, seed: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(seed=max(seed, 0) + 1,
                         device=kwargs.pop("device", "cpu"))
        if not isinstance(in_dim, (tuple, list)) or len(in_dim) == 0 \
                or not isinstance(in_dim[0], int):
            raise AssertionError(
                "in_dim must be a tuple of ints: (height, width[, channels]) "
                "for images or (length,) for spectra")
        self.in_dim = tuple(in_dim)
        self.z_dim = latent_dim
        if isinstance(discrete_dim, list):
            self.z_dim = self.z_dim + sum(discrete_dim)
        self.discrete_dim = discrete_dim
        self.coord = coord
        if coord:
            if len(in_dim) not in (2, 3):
                raise NotImplementedError(
                    "VAE with rotation and translational invariance are "
                    "available only for 2D image data")
            self.z_dim = self.z_dim + coord
            self.x_coord = imcoordgrid(self.in_dim[:2], self.device)
        self.nb_classes = nb_classes
        encoder_net, decoder_net, self.metadict = init_VAE_nets(
            self.in_dim, latent_dim, coord, discrete_dim, nb_classes,
            **kwargs)
        self.metadict["vae_type"] = type(self).__name__
        self.set_model(encoder_net, decoder_net)
        self._init_params()
        self.sigmoid_out = self.metadict["sigmoid_out"]
        self.loss = "mse"

    def load_jax_params(self, params) -> None:
        """Loads the JAX package's ``{"encoder": ..., "decoder": ...}``
        params (nested dicts of numpy arrays) of the same configuration;
        afterwards both packages compute the same function."""
        enc, dec = vae_from_jax(params, self.metadict)
        self.encoder_net.load_state_dict(enc, strict=True)
        self.decoder_net.load_state_dict(dec, strict=True)

    # --------------------------------------------------------- inference
    @torch.no_grad()
    def _encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        self.encoder_net.eval()
        with self.precision.scope(self.device):
            return self.encoder_net(x)

    @torch.no_grad()
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        self.decoder_net.eval()
        with self.precision.scope(self.device):
            if self.coord:
                xc = self.x_coord.expand((z.shape[0],) + self.x_coord.shape)
                return self.decoder_net(xc, z)
            return self.decoder_net(z)

    def encode_(self, x_new, **kwargs) -> np.ndarray:
        """Encodes data in ``num_batches`` chunks; returns the encoder's
        outputs concatenated along the last axis."""
        x_new = np.asarray(x_new, np.float32)
        if x_new.ndim == len(self.in_dim):
            x_new = x_new[None]
        x = torch.as_tensor(x_new, device=self.device)
        batch_size = max(len(x) // kwargs.get("num_batches", 10), 1)
        outs = [torch.cat([o.float() for o in self._encode(x[i:i + batch_size])],
                          -1) for i in range(0, len(x), batch_size)]
        return torch.cat(outs).cpu().numpy()

    def encode(self, x_new, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (z_mean, z_logsd)."""
        z = self.encode_(x_new, **kwargs)
        return z[:, :self.z_dim], z[:, self.z_dim:]

    def decode(self, z_sample, y: Optional[Union[int, np.ndarray]] = None
               ) -> np.ndarray:
        """Latent space -> data space; ``y`` labels a class-conditional
        model's samples."""
        z_sample = np.asarray(z_sample, np.float32)
        if z_sample.ndim == 1:
            z_sample = z_sample[None]
        if y is not None:
            if isinstance(y, int):
                y = np.array([y])
            targets = to_onehot(np.asarray(y).reshape(-1), self.nb_classes)
            if len(targets) == 1 and len(z_sample) > 1:
                targets = np.repeat(targets, len(z_sample), axis=0)
            z_sample = np.concatenate([z_sample, targets], axis=-1)
        x_decoded = self._decode(torch.as_tensor(z_sample,
                                                 device=self.device))
        if self.sigmoid_out:
            x_decoded = torch.sigmoid(x_decoded)
        return x_decoded.float().cpu().numpy()

    def reconstruct(self, x_new, **kwargs) -> np.ndarray:
        """Decodes ``num_samples`` draws from each input's encoded
        distribution (numpy seed 0), in one batched call, sample-major."""
        num_samples = kwargs.get("num_samples", 32)
        label = kwargs.get("label")
        z_mean, z_logsd = self.encode(x_new, num_batches=kwargs.get(
            "num_batches", 10))
        z_mean = z_mean[:, self.coord:]
        z_logsd = z_logsd[:, self.coord:]
        alphas = None
        if label is not None:
            alphas = to_onehot(np.array([label]), self.nb_classes)
        eps = np.random.RandomState(0).randn(num_samples, *z_mean.shape)
        z_samples = (z_mean[None] + np.exp(z_logsd)[None] * eps).reshape(
            -1, z_mean.shape[-1])
        if alphas is not None:
            per_input = np.broadcast_to(
                alphas, (z_mean.shape[0], alphas.shape[-1]))
            z_samples = np.concatenate(
                [z_samples, np.tile(per_input, (num_samples, 1))], axis=1)
        return self.decode(z_samples)

    def manifold2d(self, **kwargs) -> np.ndarray:
        """The learned 2D manifold as one (d*h, d*w[, c]) image: all d^2
        grid points decoded in one batched call. Plotting is not ported
        (``savefig`` raises)."""
        if kwargs.get("savefig"):
            raise NotImplementedError("manifold2d does not plot in the port")
        y = kwargs.get("label")
        if y is None and self.nb_classes != 0:
            y = 0
        elif y is not None and self.nb_classes == 0:
            y = None
        l1, l2 = kwargs.get("l1"), kwargs.get("l2")
        d = kwargs.get("d", 9)
        if l1 and l2:
            grid_x = np.linspace(l1[1], l1[0], d)
            grid_y = np.linspace(l2[0], l2[1], d)
        else:
            grid_x = norm_ppf(np.linspace(0.95, 0.05, d))
            grid_y = norm_ppf(np.linspace(0.05, 0.95, d))
        gx, gy = np.meshgrid(grid_x, grid_y, indexing="ij")
        z = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        imdec = self.decode(z, None if y is None
                            else np.full(len(z), y, dtype=int))
        h, w = self.in_dim[:2]
        tiles = imdec.reshape((d, d, h, w) + imdec.shape[3:])
        figure = tiles.transpose((0, 2, 1, 3) + tuple(range(4, tiles.ndim)))
        figure = figure.reshape((d * h, d * w) + imdec.shape[3:])
        if figure.min() < 0:
            figure = (figure - figure.min()) / np.ptp(figure)
        return figure

    def _check_inputs(self, X_train, y_train=None, X_test=None,
                      y_test=None) -> None:
        for name, arr in (("train", X_train), ("test", X_test)):
            if arr is not None and tuple(arr.shape[1:]) != self.in_dim:
                raise RuntimeError(
                    f"{name} data shape {tuple(arr.shape[1:])} does not "
                    f"match in_dim={self.in_dim}")
        if y_train is not None:
            if self.nb_classes == 0:
                raise RuntimeError(
                    "labels were passed but the model was constructed "
                    "with nb_classes=0")
            n_lbl = {len(np.unique(y_train))}
            if y_test is not None:
                n_lbl.add(len(np.unique(y_test)))
            if n_lbl != {self.nb_classes}:
                raise RuntimeError(
                    f"nb_classes={self.nb_classes} does not match the "
                    f"number of distinct labels {sorted(n_lbl)}")

    def _fit_loop(self, X_train, y_train, X_test, y_test, loss, **kwargs):
        """The epoch loop of every VAE flavour: train (ELBO left on the
        device), evaluate, log, checkpoint asynchronously; a synchronous
        checkpoint at the end."""
        if kwargs.get("recording"):
            raise NotImplementedError("recording manifold snapshots is not "
                                      "ported (manifold2d does not plot)")
        if int(kwargs.get("epochs_per_dispatch", 1)) != 1:
            raise NotImplementedError("the port runs one epoch at a time")
        self.compile_trainer((X_train, y_train), (X_test, y_test),
                             **kwargs)
        self.loss = loss
        if self.loss == "ce":
            self.sigmoid_out = True
            self.metadict["sigmoid_out"] = True
        verbose = kwargs.get("verbose", True)
        mlog = open_metrics_log(kwargs.get("metrics_log"))
        try:
            for e in range(self.training_cycles):
                self.current_epoch = e
                elbo = self.train_epoch_lazy()
                self.loss_history["train_loss"].append(elbo)
                elbo_test = None
                if self.X_test is not None:
                    elbo_test = self.evaluate_model_lazy()
                    self.loss_history["test_loss"].append(elbo_test)
                if mlog is not None:
                    mlog.log(e, train_elbo=float(elbo),
                             test_elbo=None if elbo_test is None
                             else float(elbo_test))
                if verbose:
                    self.print_statistics(e)
                self.update_metadict()
                self.save_model(self.filename, async_write=True)
        finally:
            self._finalize_loss_history()
            flush_async_checkpoints()
            if mlog is not None:
                mlog.close()
        self.save_model(self.filename)

    def update_metadict(self) -> None:
        self.metadict["num_epochs"] = self.current_epoch
        self.metadict["num_iter"] = self.num_iter

    def _one_hot(self, y: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if y is None:
            return None
        return F.one_hot(y.long(), self.nb_classes).float()


class VAE(BaseVAE):
    """Standard variational autoencoder.

    Example:
        >>> vae = VAE((28, 28), device="cuda")
        >>> vae.fit(imstack_train, training_cycles=100, batch_size=100)
        >>> vae.manifold2d()
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 nb_classes: int = 0, seed: int = 0, **kwargs: Any) -> None:
        super().__init__(in_dim, latent_dim, nb_classes, 0, seed=seed,
                         **kwargs)
        self.kdict_ = dc(kwargs)

    def elbo_fn(self, x, x_reconstr, *args, **kwargs):
        return vae_loss(self.loss, self.in_dim, x, x_reconstr, *args,
                        **kwargs)

    def forward_compute_elbo(self, x, y, num_iter, generator=None,
                             eps=None):
        """Encode, sample z, decode (with the one-hot labels of a
        class-conditional model), ELBO."""
        z_mean, z_logsd = self.encoder_net(x)
        z = self.reparameterize(z_mean, torch.exp(z_logsd), generator, eps)
        if y is not None:
            z = torch.cat([z, self._one_hot(y)], -1)
        x_reconstr = self.decoder_net(z)
        kw = {k: v for k, v in self.kdict_.items() if k == "capacity"}
        return self.elbo_fn(x, x_reconstr, z_mean, z_logsd,
                            num_iter=num_iter, **kw)

    def fit(self, X_train, y_train=None, X_test=None, y_test=None,
            loss: str = "mse", **kwargs) -> None:
        """Trains the VAE: ``training_cycles`` epochs of ``batch_size``."""
        X_train = np.asarray(X_train, np.float32)
        self._check_inputs(X_train, y_train, X_test, y_test)
        if "capacity" in kwargs:
            self.kdict_["capacity"] = kwargs["capacity"]
        self._fit_loop(X_train, y_train, X_test, y_test, loss, **kwargs)
