"""Variational-inference training engine of the VAE family.

Counterpart of `atomai_tpu/trainers/vitrainer.py` with one engine: a
Python loop of eager steps, in place of the JAX package's scan/loop pair
(which exists because XLA:CPU runs scan bodies single-threaded), its mesh
code and its multi-epoch dispatch. What it keeps:
- the encoder/decoder pair and their initialisation from a seed
  (`:83-101`);
- ``compile_trainer`` with Adam(1e-4) (`:161-203`): torch's Adam with
  ``eps=1e-8`` is optax's ``adam(1e-4)``, m_hat / (sqrt(v_hat) + eps);
- the epoch semantics of the loop engine (`:286-327`): a fresh
  permutation per epoch, ``nb = N // bs`` batches (the remainder is
  dropped), the epoch ELBO as the mean of the batch ELBOs, and
  ``num_iter`` advancing by ``nb``;
- epochs whose ELBO stays on the device (``train_epoch_lazy``): no host
  round trip per epoch;
- per-epoch checkpoints written by a background thread.

Random numbers come from a :class:`GeneratorSeq` seeded once: one
generator per epoch draws the permutation and every batch's noise, on the
model's device.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.checkpoint import (load_checkpoint, save_checkpoint,
                               save_checkpoint_async)
from ..core.device import resolve_device
from ..core.dtypes import default_precision
from ..core.prng import GeneratorSeq
from ..nets.blocks import init_weights_


class viBaseTrainer:
    """Base trainer for VAE models: holds the nets, the optimizer, the data
    on the device and the epoch loop."""

    def __init__(self, seed: int = 1, device: Any = "cuda"):
        self.device = resolve_device(device)
        self.keys = GeneratorSeq(seed)
        self.precision = default_precision(self.device)
        self.in_dim: Optional[Tuple[int, ...]] = None
        self.z_dim = 1
        self.encoder_net: Optional[nn.Module] = None
        self.decoder_net: Optional[nn.Module] = None
        self.initialized = False
        self.X_train = self.y_train = None
        self.X_test = self.y_test = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.current_epoch = 0
        self.num_iter = 0
        self.metadict: Dict[str, Any] = {}
        self.loss_history: Dict[str, List] = {"train_loss": [],
                                              "test_loss": []}
        self.filename = "model"
        self.training_cycles = 1
        self.batch_size = 1

    # ------------------------------------------------------------ models
    def set_model(self, encoder_net: nn.Module, decoder_net: nn.Module
                  ) -> None:
        self.encoder_net = encoder_net
        self.decoder_net = decoder_net

    def parameters(self) -> List[nn.Parameter]:
        return (list(self.encoder_net.parameters())
                + list(self.decoder_net.parameters()))

    def _init_params(self) -> None:
        """Draws the weights from the seed (encoder first, as the JAX
        package splits its key) and moves the nets to the device; once."""
        if self.initialized:
            return
        k1, k2 = self.keys.next(2)
        init_weights_(self.encoder_net, k1)
        init_weights_(self.decoder_net, k2)
        self.encoder_net.to(self.device)
        self.decoder_net.to(self.device)
        self.initialized = True

    # -------------------------------------------------------------- data
    def _to_device(self, X, y=None):
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        if y is not None:
            y = torch.as_tensor(np.asarray(y).astype(np.int64),
                                device=self.device)
        return X, y

    def set_data(self, X_train, y_train=None, X_test=None, y_test=None
                 ) -> None:
        """Stages the train (and test) data on the device once."""
        if X_train is None:
            raise AssertionError("You must provide input train/test data")
        self.X_train, self.y_train = self._to_device(X_train, y_train)
        if X_test is not None:
            self.X_test, self.y_test = self._to_device(X_test, y_test)
        else:
            self.X_test = self.y_test = None

    # ----------------------------------------------------------- compile
    def compile_trainer(self, train_data: Tuple,
                        test_data: Optional[Tuple] = None,
                        training_cycles: int = 100, batch_size: int = 32,
                        **kwargs) -> None:
        """Stages the data and initialises the weights and Adam(1e-4)."""
        self.training_cycles = training_cycles
        self.batch_size = batch_size
        if test_data is not None and test_data[0] is not None:
            self.set_data(*train_data, *test_data)
        else:
            self.set_data(*train_data)
        self._init_params()
        if self.optimizer is None:
            self.optimizer = torch.optim.Adam(self.parameters(), lr=1e-4,
                                              eps=1e-8)
        self.filename = kwargs.get("filename", "./model")

    # ---------------------------------------------------- reparameterize
    @staticmethod
    def reparameterize(z_mean: torch.Tensor, z_sd: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z_mean + z_sd * eps, with eps ~ N(0, 1) drawn from ``generator``
        unless given."""
        if eps is None:
            eps = torch.randn(z_mean.shape, generator=generator,
                              device=z_mean.device, dtype=z_mean.dtype)
        return z_mean + z_sd * eps

    # ------------------------------------------------------------ engine
    def forward_compute_elbo(self, x: torch.Tensor,
                             y: Optional[torch.Tensor], num_iter: int,
                             generator: Optional[torch.Generator] = None,
                             eps: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Forward pass and ELBO of one batch; subclasses implement."""
        raise NotImplementedError

    def _elbo(self, x, y, num_iter, generator):
        with self.precision.scope(self.device):
            return self.forward_compute_elbo(x, y, num_iter, generator)

    def _batches(self, N: int) -> Tuple[int, int]:
        bs = min(self.batch_size, N)
        return bs, max(N // bs, 1)

    def train_epoch_lazy(self) -> torch.Tensor:
        """Trains one epoch; returns its mean ELBO as a device scalar
        (no host synchronisation)."""
        N = int(self.X_train.shape[0])
        bs, nb = self._batches(N)
        g = self.keys.next(device=self.device)
        perm = torch.randperm(N, generator=g, device=self.device)
        perm = perm[:nb * bs].view(nb, bs)
        self.encoder_net.train()
        self.decoder_net.train()
        elbo_sum = torch.zeros((), device=self.device)
        for i in range(nb):
            idx = perm[i]
            y_i = self.y_train[idx] if self.y_train is not None else None
            self.optimizer.zero_grad(set_to_none=True)
            with self.precision.tf32_scope():   # the backward's GEMMs too
                elbo = self._elbo(self.X_train[idx], y_i, self.num_iter + i,
                                  g)
                (-elbo).backward()
            self.optimizer.step()
            elbo_sum = elbo_sum + elbo.detach()
        self.num_iter += nb
        return elbo_sum / nb

    def train_epoch(self) -> float:
        """Trains one epoch; returns its mean ELBO."""
        return float(self.train_epoch_lazy())

    @torch.no_grad()
    def evaluate_model_lazy(self) -> torch.Tensor:
        """Mean test-set ELBO over in-order batches, as a device scalar."""
        if self.X_test is None:
            return torch.zeros((), device=self.device)
        Nt = int(self.X_test.shape[0])
        bst, nbt = self._batches(Nt)
        g = self.keys.next(device=self.device)
        self.encoder_net.eval()
        self.decoder_net.eval()
        elbo_sum = torch.zeros((), device=self.device)
        for i in range(nbt):
            sl = slice(i * bst, (i + 1) * bst)
            y_i = self.y_test[sl] if self.y_test is not None else None
            elbo_sum = elbo_sum + self._elbo(self.X_test[sl], y_i,
                                             self.num_iter, g)
        return elbo_sum / nbt

    def evaluate_model(self) -> float:
        return float(self.evaluate_model_lazy())

    def _finalize_loss_history(self) -> None:
        """Device scalars of the lazy epochs -> floats, in one copy."""
        for k, vals in self.loss_history.items():
            if vals and isinstance(vals[0], torch.Tensor):
                self.loss_history[k] = torch.stack(vals).cpu().tolist()

    def print_statistics(self, e: int) -> None:
        line = "Epoch: {}/{}, Training loss: {:.4f}".format(
            e + 1, self.training_cycles,
            -float(self.loss_history["train_loss"][-1]))
        if self.X_test is not None:
            line += ", Test loss: {:.4f}".format(
                -float(self.loss_history["test_loss"][-1]))
        print(line)

    # --------------------------------------------------------- serialize
    def _state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"encoder": self.encoder_net.state_dict(),
                "decoder": self.decoder_net.state_dict()}

    def save_model(self, *args: str, async_write: bool = False) -> str:
        """Writes the metadict and the weights to ``<name>.aoit``;
        ``async_write`` leaves the copy and the write to the background
        thread (flushed at the end of ``fit``)."""
        savepath = args[0] if args else self.filename
        meta = {k: v for k, v in self.metadict.items()
                if k not in ("encoder", "decoder", "optimizer")}
        arrays = {"params": self._state()}
        if async_write:
            return save_checkpoint_async(savepath, meta, arrays)
        return save_checkpoint(savepath, meta, arrays)

    def save_weights(self, *args: str) -> str:
        savepath = args[0] if args else (self.filename + "weights")
        return save_checkpoint(savepath, {"model_type": "weights"},
                               {"params": self._state()})

    def load_weights(self, filepath: str) -> None:
        """Loads weights saved by :meth:`save_model` or
        :meth:`save_weights`."""
        _, arrays = load_checkpoint(filepath)
        self._init_params()
        self.encoder_net.load_state_dict(arrays["params"]["encoder"])
        self.decoder_net.load_state_dict(arrays["params"]["decoder"])
