"""BaseVAE and the standard VAE.

Counterpart of `atomai_tpu/models/dgm/vae.py:29-508`: encode / decode /
reconstruct in batches (with the discrete latents of the joint models),
the encoding of every pixel of an image through the window around it and
of atom trajectories, the 2D manifold and the joint latent traversal as
arrays (``savefig`` writes the manifold as a PNG), input checks, the
epoch loop of ``fit`` with a per-epoch (or per-chunk, with
``epochs_per_dispatch``) checkpoint and the optional manifold recording,
and the VAE's class-conditional ELBO (one-hot labels concatenated to z).
Spans (``core.profiling``): ``vae.fit`` around a fit, ``vae.fetch``
around an epoch's ELBO copy to the host. Plotting imports matplotlib, and
the GIF of a recording PIL, inside the functions that draw.
"""

import os
from copy import deepcopy as dc
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...core import profiling
from ...core.checkpoint import flush_async_checkpoints
from ...core.mlog import open_metrics_log
from ...losses_metrics.vi_losses import vae_loss
from ...nets.ed import init_VAE_nets
from ...trainers.vitrainer import viBaseTrainer
from ...utils.coords import (imcoordgrid, subimg_trajectories,
                             transform_coordinates)
from ...utils.img import crop_borders, extract_subimages, get_coord_grid
from ...utils.preproc import to_onehot
from ..conversion import vae_from_jax


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2
              ) -> np.ndarray:
    """Tiles (N, C, H, W) images into one (C, H', W') grid image, ``nrow``
    to a row with ``padding`` zero pixels around each (torchvision's
    ``make_grid`` layout)."""
    n, c, h, w = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.zeros((c, ncol * (h + padding) + padding,
                     nrow * (w + padding) + padding), images.dtype)
    for idx in range(n):
        i, j = divmod(idx, nrow)
        y0 = i * (h + padding) + padding
        x0 = j * (w + padding) + padding
        grid[:, y0:y0 + h, x0:x0 + w] = images[idx]
    return grid


def norm_ppf(q: np.ndarray) -> np.ndarray:
    """Standard normal percent-point function."""
    from scipy.stats import norm
    return norm.ppf(q)


class BaseVAE(viBaseTrainer):
    """General class for VAE models.

    Keyword args besides the nets' (``numlayers_encoder``,
    ``numhidden_decoder``, ``conv_encoder``, ``conv_decoder``, ...):
    ``device`` ("cuda", the default, needs a card and raises without one;
    "cpu" when asked for). ``seed`` gives the weights and every random draw
    of ``fit``, as in the JAX package (``max(seed, 0) + 1`` seeds the
    stream).
    """

    def __init__(self, in_dim: Tuple[int, ...] = None, latent_dim: int = 2,
                 nb_classes: int = 0, coord: int = 0,
                 discrete_dim: Optional[List[int]] = None, seed: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(seed=max(seed, 0) + 1,
                         device=kwargs.pop("device", "cuda"))
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

    def encode(self, x_new, **kwargs) -> Tuple[np.ndarray, ...]:
        """Returns (z_mean, z_logsd), and the discrete latents' softmax
        parameters (alphas, concatenated) of a joint model."""
        z = self.encode_(x_new, **kwargs)
        if not self.discrete_dim:
            return z[:, :self.z_dim], z[:, self.z_dim:]
        cont_dim = self.z_dim - sum(self.discrete_dim)
        return z[:, :cont_dim], z[:, cont_dim:2 * cont_dim], \
            z[:, 2 * cont_dim:]

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
        distribution (numpy seed 0), in one batched call, sample-major. A
        joint model decodes with the encoded alphas; ``label`` replaces
        them (or a conditional model's class) by one one-hot category."""
        num_samples = kwargs.get("num_samples", 32)
        label = kwargs.get("label")
        encoded = self.encode(x_new, num_batches=kwargs.get(
            "num_batches", 10))
        z_mean, z_logsd = encoded[:2]
        alphas = encoded[2] if len(encoded) == 3 else None
        z_mean = z_mean[:, self.coord:]
        z_logsd = z_logsd[:, self.coord:]
        if label is not None:
            n = self.nb_classes if self.discrete_dim is None \
                else sum(self.discrete_dim)
            alphas = to_onehot(np.array([label]), n)
        eps = np.random.RandomState(0).randn(num_samples, *z_mean.shape)
        z_samples = (z_mean[None] + np.exp(z_logsd)[None] * eps).reshape(
            -1, z_mean.shape[-1])
        if alphas is not None:
            per_input = np.broadcast_to(
                alphas, (z_mean.shape[0], alphas.shape[-1]))
            z_samples = np.concatenate(
                [z_samples, np.tile(per_input, (num_samples, 1))], axis=1)
        return self.decode(z_samples)

    def encode_images(self, imgdata, **kwargs
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Encodes every pixel of every image through the window around it
        (:meth:`encode_image_`): (cropped images, their latent maps)."""
        if imgdata.ndim == len(self.in_dim):
            imgdata = imgdata[None]
        cropped, encoded = [], []
        for i, img in enumerate(imgdata):
            print(f"\rImage {i + 1}/{len(imgdata)}", end="")
            c, e = self.encode_image_(img, **kwargs)
            cropped.append(c)
            encoded.append(e)
        return np.array(cropped), np.array(encoded)

    def encode_image_(self, img, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """The continuous latent means of the in_dim[0]-sided window around
        each pixel of a 2D image, in ``num_batches`` chunks of windows.
        Pixels whose window leaves the image keep the -1e5 marker and are
        cropped away with the image's zero borders: (cropped image,
        (h', w', latents) map)."""
        num_batches = kwargs.get("num_batches", 10)
        marker = -float(1e5)
        img_out = img.copy()
        coordinates = get_coord_grid(img_out, 1, return_dict=False)
        chunk = max(coordinates.shape[0] // num_batches, 1)
        # the map holds the continuous means, z_dim less the discrete
        # latents of a joint model
        zw = self.z_dim - (sum(self.discrete_dim)
                           if self.discrete_dim else 0)
        encoded_img = np.full((*img_out.shape, zw), marker, np.float32)
        for i in range(0, coordinates.shape[0], chunk):
            windows, centers, _ = extract_subimages(
                img_out, coordinates[i:i + chunk], self.in_dim[0])
            if len(windows) == 0:
                continue
            z_mean = self.encode(windows.squeeze(-1), num_batches=1)[0]
            ij = centers.astype(np.int64)
            encoded_img[ij[:, 0], ij[:, 1]] = z_mean
        img_out[encoded_img[..., 0] == marker] = 0
        img_out = crop_borders(img_out[..., None], 0)
        encoded_img = crop_borders(encoded_img, marker)
        return img_out[..., 0], encoded_img

    def encode_trajectories(self, imgdata, coord_class_dict,
                            window_size: int, min_length: int, rmax: int,
                            **kwargs):
        """Atom trajectories through a stack ({frame: (n, 3) [row, col,
        class]}, nearest-neighbour chained within ``rmax``) with the
        latent means of the window around each tracked position: ([(m,
        2 + latents)], frames, windows) for each track longer than
        ``min_length``."""
        t = subimg_trajectories(imgdata, coord_class_dict, window_size,
                                min_length, rmax)
        trajectories, frames, subimgs_all = t.get_all_trajectories()
        trajectories_enc_all = []
        for traj, subimgs in zip(trajectories, subimgs_all):
            z_mean = self.encode(
                subimgs, num_batches=kwargs.get("num_batches", 10))[0]
            trajectories_enc_all.append(
                np.concatenate((traj[:, :2], z_mean), axis=-1))
        return trajectories_enc_all, frames, subimgs_all

    def manifold2d(self, **kwargs) -> np.ndarray:
        """The learned 2D manifold as one (d*h, d*w[, c]) image: all d^2
        grid points decoded in one batched call; a joint model's discrete
        latents are the one-hot of ``disc_idx``. ``savefig`` writes it to
        ``savedir``/``filename``.png (matplotlib)."""
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
        if self.discrete_dim:
            z_disc = np.zeros((len(z), sum(self.discrete_dim)))
            z_disc[:, kwargs.get("disc_idx", 0)] = 1
            z = np.concatenate([z, z_disc], axis=-1)
        imdec = self.decode(z, None if y is None
                            else np.full(len(z), y, dtype=int))
        h, w = self.in_dim[:2]
        tiles = imdec.reshape((d, d, h, w) + imdec.shape[3:])
        figure = tiles.transpose((0, 2, 1, 3) + tuple(range(4, tiles.ndim)))
        figure = figure.reshape((d * h, d * w) + imdec.shape[3:])
        if figure.min() < 0:
            figure = (figure - figure.min()) / np.ptp(figure)
        if kwargs.get("savefig"):
            from ...utils.viz import _plt
            plt = _plt()
            fig, ax = plt.subplots(figsize=(10, 10))
            ax.imshow(figure, cmap=kwargs.get("cmap", "gnuplot"),
                      origin=kwargs.get("origin", "lower"))
            savedir = kwargs.get("savedir", "./vae_learning/")
            os.makedirs(savedir, exist_ok=True)
            fname = kwargs.get("filename", "manifold_2d")
            fig.savefig(os.path.join(savedir, f"{fname}.png"))
            plt.close(fig)
        return figure

    def manifold_traversal(self, cont_idx: int, d: int = 10,
                           cont_idx_fixed: int = 0, plot: bool = False,
                           **kwargs) -> np.ndarray:
        """A joint model's latent traversal as one grid image: columns
        sweep continuous latent ``cont_idx`` through normal quantiles (the
        others fixed at ``cont_idx_fixed``), rows cycle through the first
        discrete latent's categories. Normalised to [0, 1]; cut to the
        categories' rows unless ``keep_square``."""
        if self.discrete_dim is None:
            raise TypeError(
                "Traversal of latent space is implemented only for joint "
                "continuous and discrete latent distributions")
        cont_dim = self.z_dim - sum(self.discrete_dim) - self.coord
        disc_dim = self.discrete_dim[0]
        cont_traversal = norm_ppf(np.linspace(0.05, 0.95, d))
        samples_cont = np.full((d * d, cont_dim), float(cont_idx_fixed))
        samples_cont[:, cont_idx] = np.tile(cont_traversal, d)
        row_categories = np.resize(np.arange(disc_dim), d)
        samples_disc = np.repeat(np.eye(disc_dim)[row_categories], d, axis=0)
        decoded = self.decode(np.concatenate((samples_cont, samples_disc),
                                             -1))
        decoded = decoded.transpose(0, 3, 1, 2) if decoded.ndim == 4 \
            else decoded[:, None]
        pad = kwargs.get("pad", 2)
        grid = make_grid(decoded, nrow=d, padding=pad)
        grid = grid.transpose(1, 2, 0) if len(self.in_dim) == 3 else grid[0]
        grid = (grid - grid.min()) / max(np.ptp(grid), 1e-12)
        if not kwargs.get("keep_square", False) and disc_dim != d:
            grid = grid[:(self.in_dim[0] + pad) * disc_dim]
        return grid

    @classmethod
    def visualize_manifold_learning(cls, frames_dir: str, **kwargs) -> None:
        """A GIF (``moviename``.gif in the working directory, PIL) of the
        PNGs a recording left in ``frames_dir``."""
        from ...utils.viz import animation_from_png
        animation_from_png(frames_dir,
                           kwargs.get("moviename", "manifold_learning"),
                           kwargs.get("frame_duration", 1), remove_dir=False)

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

    def _prepare_fit(self, X_train, y_train, X_test, y_test, kwargs,
                     keys) -> None:
        """Checks the inputs, sets a rotational model's priors
        (``rotation_prior``, ``translation_prior``: 0.1 by default) and
        keeps the ELBO options ``keys`` found in ``fit``'s kwargs."""
        self._check_inputs(np.asarray(X_train), y_train, X_test, y_test)
        if self.coord:
            self.dx_prior = kwargs.get("translation_prior", 0.1)
            self.kdict_["phi_prior"] = kwargs.get("rotation_prior", 0.1)
        self.kdict_.update({k: kwargs[k] for k in keys if k in kwargs})

    def _transformed_grid(self, z: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A rotational model's pixel grid, rotated by z[:, 0] and (with
        translation) shifted by ``dx_prior`` * z[:, 1:3], and the latents
        left for the decoder."""
        x_coord = self.x_coord.expand((z.shape[0],) + self.x_coord.shape)
        if self.translation:
            dx = (z[:, 1:3] * self.dx_prior)[:, None, :]
            rest = z[:, 3:]
        else:
            dx, rest = 0, z[:, 1:]
        return transform_coordinates(x_coord, z[:, 0], dx), rest

    def _static_draws(self) -> bool:
        """Every model of the family: a step's ELBO reads its batch, its
        Gaussian noise, each discrete head's uniforms (a joint model's) and
        its step count (the capacity schedules'), all of which
        ``forward_compute_elbo`` takes."""
        return True

    def _fit_loop(self, X_train, y_train, X_test, y_test, loss, **kwargs):
        """The epoch loop of every VAE flavour: ``epochs_per_dispatch``
        epochs at a time (1 by default), each dispatch one
        :meth:`_fit_epochs`; a synchronous checkpoint at the end.
        ``recording`` (a model with 3 or 5 latents: an rVAE's) writes the
        manifold's PNG after every epoch and a GIF of them at the end."""
        with profiling.span("vae.fit"):
            self.compile_trainer((X_train, y_train), (X_test, y_test),
                                 **kwargs)
            self.loss = loss
            if self.loss == "ce":
                self.sigmoid_out = True
                self.metadict["sigmoid_out"] = True
            self.recording = kwargs.get("recording", False)
            record = self.recording and self.z_dim in (3, 5)
            epd = 1 if record else max(1, int(kwargs.get(
                "epochs_per_dispatch", 1)))
            verbose = kwargs.get("verbose", True)
            mlog = open_metrics_log(kwargs.get("metrics_log"))
            try:
                e = 0
                while e < self.training_cycles:
                    k = min(epd, self.training_cycles - e)
                    self._fit_epochs(e, k, verbose, mlog, record)
                    e += k
            finally:
                self._finalize_loss_history()
                flush_async_checkpoints()
                if mlog is not None:
                    mlog.close()
            self._sync_replicas()
            self.save_model(self.filename)
            if record:
                self.visualize_manifold_learning("./vae_learning")

    def _fit_epochs(self, e: int, k: int, verbose: bool = True, mlog=None,
                    record: bool = False) -> None:
        """Epochs ``e`` .. ``e + k - 1`` of a fit, one dispatch: trained
        (and evaluated on a test set) with their ELBOs left on the device
        and added to the loss history; then one fetch of the ELBOs for the
        prints (``verbose``) or the metrics log, the manifold's PNG
        (``record``), the metadict and an asynchronous checkpoint to
        ``filename``."""
        self.current_epoch = e + k - 1
        elbos, elbos_t = self.train_epochs_lazy(k)
        self.loss_history["train_loss"].extend(elbos.unbind())
        if elbos_t is not None:
            self.loss_history["test_loss"].extend(elbos_t.unbind())
        if mlog is not None or verbose:
            with profiling.span("vae.fetch"):
                tr = elbos.cpu().numpy()
                ts = None if elbos_t is None else elbos_t.cpu().numpy()
            if mlog is not None:
                mlog.log_many(e, train_elbo=tr, test_elbo=ts)
            if verbose:
                for i in range(k):
                    self.print_statistics(
                        e + i, tr[i], None if ts is None else ts[i])
        if record:
            self.manifold2d(savefig=True, filename=str(e))
        self.update_metadict()
        self.save_model(self.filename, async_write=True)

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
        self._prepare_fit(X_train, y_train, X_test, y_test, kwargs,
                          ("capacity",))
        self._fit_loop(X_train, y_train, X_test, y_test, loss, **kwargs)
