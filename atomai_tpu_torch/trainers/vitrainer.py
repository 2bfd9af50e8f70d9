"""Variational-inference training engine of the VAE family.

Counterpart of `atomai_tpu/trainers/vitrainer.py` with one engine: a
Python loop of eager steps, in place of the JAX package's scan/loop pair
(which exists because XLA:CPU runs scan bodies single-threaded). What it
keeps:
- the encoder/decoder pair and their initialisation from a seed
  (`:83-101`);
- ``compile_trainer`` with Adam(1e-4) (`:161-203`): torch's Adam with
  ``eps=1e-8`` is optax's ``adam(1e-4)``, m_hat / (sqrt(v_hat) + eps);
  ``optimizer="sgd"`` is plain SGD at 1e-4, and a callable
  ``params -> torch.optim.Optimizer`` is used as given;
- the epoch semantics of the loop engine (`:286-327`): a fresh
  permutation per epoch, ``nb = N // bs`` batches (the remainder is
  dropped), the epoch ELBO as the mean of the batch ELBOs, and
  ``num_iter`` advancing by ``nb``;
- epochs whose ELBO stays on the device (``train_epoch_lazy``): no host
  round trip per epoch; ``train_epochs_lazy(n)`` runs n of them with the
  semantics of the JAX package's multi-epoch dispatch (`:406-465`);
- the Gaussian and Gumbel-softmax reparameterisations and the log-pdfs
  (`:206-234`);
- per-epoch checkpoints written by a background thread (the weights'
  copy to the host on the caller's thread, the write on the thread);
- on one card, the step of every VAE of the family (the plain VAE, the
  rVAE, the joint jVAE and jrVAE, with or without capacity schedules)
  replayed from a CUDA graph (``core/graphs.py``) after ``GRAPH_WARMUP``
  eager steps (:meth:`viBaseTrainer._graphed` says when): each step takes
  its index slice, its Gaussian noise, each discrete head's Gumbel
  uniforms and its step count (``num_iter``, which the capacity schedules
  read, a device scalar there) as the graph's static inputs. On a card
  these models draw an epoch's permutation, then every batch's noise,
  then each head's uniforms, before its first step on every route (a
  mesh, labels or remat run the eager loop), so that a seed gives one fit
  whatever the route; on the CPU each step draws its own as the JAX
  package does. Adam keeps its state on the card (``capturable``), so
  eager and replayed steps are the same arithmetic;
- data parallelism (`:139-175, 250-305`): in a world of several ranks
  ``compile_trainer(mesh=None)`` builds a data mesh sized to the largest
  rank count that divides the batch (``mesh=False`` opts out, a
  ``DeviceMesh`` is used as given; kept across compile calls). Each
  minibatch the data axis divides is split: every rank draws the global
  permutation and the global batch's noise (reparameterisation, Gumbel)
  from the same generator and keeps its rows, computes the ELBO of the
  global batch (the losses' batch means are all-reduced, BatchNorm takes
  the global statistics) on its rows, and the gradients are averaged over
  the data axis. The spatial-MLP kernels run on each rank's rows. Every
  rank holds the same weights and ELBO history; the test set is scored
  whole on every rank.

Random numbers come from a :class:`GeneratorSeq` seeded once: one
generator per epoch draws the permutation and every batch's noise and
uniforms, on the model's device.

Spans (``core.profiling``): ``vae.epoch`` (an epoch's launches from the
host), ``vae.checkpoint`` (an asynchronous checkpoint's host side) and
its ``vae.checkpoint.fetch`` (the weights' copy to the host); the models
add ``vae.fit`` and ``vae.fetch``. Counters, each a training step, counted
here since a replay runs no host code in the nets: by the step's route,
``vae.eager_step``, ``vae.graph_capture``, ``vae.graph_replay``; and, for
a spatial decoder, by the decoder's, ``vae.decoder_fused_step`` (one
:func:`spatial_mlp` call: the kernels on a card) or
``vae.decoder_layerwise_step``.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core import graphs, profiling
from ..core.checkpoint import (is_jax_tree, load_checkpoint,
                               save_checkpoint, save_checkpoint_async)
from ..core.device import resolve_device
from ..core.dtypes import default_precision
from ..core.mesh import (DATA_AXIS, axis_size, draw_rows, mean_gradients,
                         resolve_data_mesh, shard_batch, split_batch,
                         split_mean, splits, sync_from_rank0)
from ..core.prng import GeneratorSeq
from ..nets.blocks import init_weights_
from ..nets.remat import set_remat
from ..parallel.sync_bn import global_batch_norm

# eager steps of a graphed route before its capture (cuBLAS plans, the
# kernels' workspaces and Adam's state are made there)
GRAPH_WARMUP = 2
_STAGE_COUNTERS = {"eager": "vae.eager_step", "capture": "vae.graph_capture",
                   "replay": "vae.graph_replay"}


class viBaseTrainer:
    """Base trainer for VAE models: holds the nets, the optimizer, the data
    on the device and the epoch loop."""

    def __init__(self, seed: int = 1, device: Any = "cuda"):
        self.device = resolve_device(device)
        self.keys = GeneratorSeq(seed)
        self.precision = default_precision(self.device)
        self.in_dim: Optional[Tuple[int, ...]] = None
        # every latent, and the discrete heads' sizes among them
        self.z_dim = 1
        self.discrete_dim: Optional[List[int]] = None
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
        self.remat = False
        # the data mesh (resolved), the caller's choice (None, False or a
        # DeviceMesh, kept across compile calls), and whether the ELBO is
        # a user's (a mean over the rows it is given)
        self.mesh = None
        self._mesh_pref = None
        self._local_elbo = False
        # the graphed route's step and what it was captured for
        self._graph: Optional[graphs.GraphedCall] = None
        self._graph_key = None

    # ------------------------------------------------------------ models
    def set_model(self, encoder_net: nn.Module, decoder_net: nn.Module
                  ) -> None:
        self.encoder_net = encoder_net
        self.decoder_net = decoder_net

    def set_encoder(self, encoder_net: nn.Module) -> None:
        """Replaces the encoder (a user's net; weights drawn at compile
        time unless the trainer is initialised already)."""
        self.encoder_net = encoder_net

    def set_decoder(self, decoder_net: nn.Module) -> None:
        """Replaces the decoder, as :meth:`set_encoder`."""
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

    def set_data(self, X_train, y_train=None, X_test=None, y_test=None,
                 memory_alloc: float = 4) -> None:
        """Stages the train (and test) data on the device once
        (``memory_alloc`` is accepted and unused: the data always go to
        the device)."""
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
                        optimizer: Any = None, elbo_fn: Any = None,
                        **kwargs) -> None:
        """Stages the data and initialises the weights and the optimizer:
        ``optimizer`` "adam" (the default) or "sgd" at lr 1e-4, or a
        callable ``params -> torch.optim.Optimizer``. ``remat=True``
        recomputes the encoder's and the decoder's activations in the
        backward (``nets/remat.py``; kept across compile calls); the noise
        is drawn between them, outside any recompute. ``mesh``: None for
        the automatic data mesh, False for none, or a ``DeviceMesh``."""
        pref = kwargs.get("mesh", self._mesh_pref)
        self.mesh = resolve_data_mesh(pref, batch_size)
        self._mesh_pref = pref
        self.remat = bool(kwargs.get("remat", self.remat))
        self.training_cycles = training_cycles
        self.batch_size = batch_size
        if elbo_fn is not None:
            # shadows the model's elbo_fn method, as in the JAX package
            self.elbo_fn = elbo_fn
            self._local_elbo = True
        if test_data is not None and test_data[0] is not None:
            self.set_data(*train_data, *test_data)
        else:
            self.set_data(*train_data)
        self._init_params()
        set_remat(self.encoder_net, self.remat)
        set_remat(self.decoder_net, self.remat)
        if self.optimizer is None:
            self.optimizer = self._make_optimizer(optimizer)
        self.filename = kwargs.get("filename", "./model")
        self._graph = None      # new data, priors and options: capture anew

    def _make_optimizer(self, optimizer: Any) -> torch.optim.Optimizer:
        if optimizer is not None and not isinstance(optimizer, str):
            return optimizer(self.parameters())
        name = optimizer or "adam"
        if name == "adam":
            # its state on the card there, so that a graph can replay it
            return torch.optim.Adam(self.parameters(), lr=1e-4, eps=1e-8,
                                    capturable=self.device.type == "cuda")
        if name == "sgd":
            return torch.optim.SGD(self.parameters(), lr=1e-4)
        raise ValueError(f"Unknown optimizer '{name}': use 'adam', 'sgd' or "
                         "a callable params -> optimizer")

    # ---------------------------------------------------- reparameterize
    @staticmethod
    def reparameterize(z_mean: torch.Tensor, z_sd: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z_mean + z_sd * eps, with eps ~ N(0, 1) drawn from ``generator``
        unless given."""
        if eps is None:
            eps = draw_rows(torch.randn, z_mean.shape, generator=generator,
                            device=z_mean.device, dtype=z_mean.dtype)
        return z_mean + z_sd * eps

    @staticmethod
    def reparameterize_discrete(alpha: torch.Tensor, tau: float,
                                generator: Optional[torch.Generator] = None,
                                u: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
        """Gumbel-softmax sample of the categorical ``alpha`` (B, k) at
        temperature ``tau``, in float32: softmax((log(alpha + eps) + g) /
        tau) over axis 1, g = -log(-log(u + eps) + eps), eps = 1e-12 and
        u ~ U(0, 1) drawn from ``generator`` unless given."""
        eps = 1e-12
        with torch.autocast(alpha.device.type, enabled=False):
            alpha = alpha.float()
            if u is None:
                u = draw_rows(torch.rand, alpha.shape, generator=generator,
                              device=alpha.device)
            gumbel = -torch.log(-torch.log(u.float() + eps) + eps)
            logit = (torch.log(alpha + eps) + gumbel) / tau
            return torch.softmax(logit, 1)

    @staticmethod
    def log_normal(x: torch.Tensor, mu: torch.Tensor,
                   log_sd: torch.Tensor) -> torch.Tensor:
        """log-pdf of a diagonal normal, summed over the last axis."""
        log_pdf = (-0.5 * float(np.log(2 * np.pi)) - log_sd
                   - (x - mu) ** 2 / (2 * torch.exp(log_sd) ** 2))
        return torch.sum(log_pdf, -1)

    @staticmethod
    def log_unit_normal(x: torch.Tensor) -> torch.Tensor:
        """log-pdf of the unit normal, summed over the last axis."""
        return torch.sum(-0.5 * (float(np.log(2 * np.pi)) + x ** 2), -1)

    # ------------------------------------------------------------ engine
    def forward_compute_elbo(self, x: torch.Tensor,
                             y: Optional[torch.Tensor], num_iter: int,
                             generator: Optional[torch.Generator] = None,
                             eps: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Forward pass and ELBO of one batch; subclasses implement."""
        raise NotImplementedError

    def _elbo(self, x, y, num_iter, generator, eps=None, u=None):
        with self.precision.scope(self.device):
            return self.forward_compute_elbo(x, y, num_iter, generator,
                                             **self._draw_kwargs(eps, u))

    @staticmethod
    def _draw_kwargs(eps, u) -> Dict[str, Any]:
        """A step's drawn numbers as ``forward_compute_elbo`` takes them:
        ``eps``, and ``u`` (a list, one tensor a head) for a joint model."""
        return {"eps": eps} if u is None else {"eps": eps, "u": list(u)}

    def _batches(self, N: int) -> Tuple[int, int]:
        bs = min(self.batch_size, N)
        return bs, max(N // bs, 1)

    def _static_draws(self) -> bool:
        """Whether a training step's ELBO is a function of its batch, its
        Gaussian noise, each discrete head's Gumbel uniforms (the layouts
        of :meth:`_epoch_draws` and :meth:`_uniform_draws`) and its step
        count alone, each of which ``forward_compute_elbo`` takes. The
        models say; the base trainer does not know its ELBO."""
        return False

    def _noise_up_front(self) -> bool:
        """Whether an epoch draws every batch's noise and uniforms before
        its first step (:meth:`_epoch_draws`, :meth:`_uniform_draws`): on
        a card, for a model with static draws, whatever the route, so that
        a seed gives one fit on every route; elsewhere each step draws its
        own, as the JAX package's loop does."""
        return self.device.type == "cuda" and self._static_draws()

    def _graphed(self) -> bool:
        """Whether the epoch's steps replay from a CUDA graph: draws made
        up front, no mesh, no labels, no remat, the model's own ELBO and
        the trainer's capturable Adam."""
        opt = self.optimizer
        return (self._noise_up_front() and self.mesh is None
                and self.y_train is None and not self.remat
                and not self._local_elbo
                and isinstance(opt, torch.optim.Adam)
                and bool(opt.defaults.get("capturable")))

    def train_epoch_lazy(self) -> torch.Tensor:
        """Trains one epoch; returns its mean ELBO as a device scalar
        (no host synchronisation)."""
        with profiling.span("vae.epoch"):
            N = int(self.X_train.shape[0])
            bs, nb = self._batches(N)
            g = self.keys.next(device=self.device)
            perm, noise = self._epoch_draws(g, N, bs, nb)
            u = self._uniform_draws(g, nb, bs)
            self.encoder_net.train()
            self.decoder_net.train()
            if self._graphed():
                elbo = self._train_epoch_graphed(perm, noise, u, bs)
            else:
                elbo = self._train_epoch_eager(perm, noise, u, g)
            fused = getattr(self.decoder_net, "fused", None)
            if callable(fused):
                profiling.count("vae.decoder_fused_step" if fused()
                                else "vae.decoder_layerwise_step", nb)
            self.num_iter += nb
            return elbo

    def _train_epoch_eager(self, perm: torch.Tensor,
                           noise: Optional[torch.Tensor],
                           u: Optional[List[torch.Tensor]],
                           g: torch.Generator) -> torch.Tensor:
        nb, bs = perm.shape
        split = splits(self.mesh, DATA_AXIS) and \
            bs % axis_size(self.mesh, DATA_AXIS) == 0
        mesh = self.mesh if split else None
        elbo_sum = torch.zeros((), device=self.device)
        for i in range(nb):
            idx = shard_batch(mesh, perm[i])
            y_i = self.y_train[idx] if self.y_train is not None else None
            eps = None if noise is None else shard_batch(mesh, noise[i])
            u_i = None if u is None else [shard_batch(mesh, t[i]) for t in u]
            self.optimizer.zero_grad(set_to_none=True)
            with self.precision.tf32_scope(), split_batch(mesh), \
                    global_batch_norm(self.encoder_net), \
                    global_batch_norm(self.decoder_net):
                elbo = self._elbo(self.X_train[idx], y_i, self.num_iter + i,
                                  g, eps, u_i)
                if self._local_elbo:
                    elbo = split_mean(elbo)
                (-elbo).backward()     # the backward's GEMMs under TF32 too
            mean_gradients(self.parameters(), self.mesh)
            self.optimizer.step()
            elbo_sum = elbo_sum + elbo.detach()
        profiling.count("vae.eager_step", nb)
        return elbo_sum / nb

    def _epoch_draws(self, g: torch.Generator, N: int, bs: int, nb: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """An epoch's first draws from its generator: the permutation's
        first nb * bs indices as (nb, bs), then, where the draws are made
        up front (:meth:`_noise_up_front`), every batch's Gaussian
        reparameterisation noise (nb, bs, the continuous latents), else
        None."""
        perm = torch.randperm(N, generator=g, device=self.device)
        eps = torch.randn((nb, bs, self.z_dim - sum(self.discrete_dim or ())),
                          generator=g, device=self.device) \
            if self._noise_up_front() else None
        return perm[:nb * bs].view(nb, bs), eps

    def _uniform_draws(self, g: torch.Generator, nb: int, bs: int
                       ) -> Optional[List[torch.Tensor]]:
        """Where the draws are made up front, after :meth:`_epoch_draws`'
        the Gumbel-softmax uniforms of every batch, each discrete head's in
        turn: [(nb, bs, k) for k in ``discrete_dim``]; else (or without
        discrete latents) None."""
        if not (self.discrete_dim and self._noise_up_front()):
            return None
        return [torch.rand((nb, bs, k), generator=g, device=self.device)
                for k in self.discrete_dim]

    def _graph_step(self, idx: torch.Tensor, eps: torch.Tensor,
                    num_iter: Optional[torch.Tensor] = None, *u: torch.Tensor
                    ) -> torch.Tensor:
        """One Adam step on the batch ``X_train[idx]`` with the noise
        ``eps`` (and each discrete head's uniforms ``u``) at the step count
        ``num_iter`` (a device scalar; ``self.num_iter`` if None): the
        ELBO, its backward under the policy's TF32 switch and the
        optimizer's step; returns the ELBO, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        it = self.num_iter if num_iter is None else num_iter
        with self.precision.tf32_scope():
            with self.precision.scope(self.device):
                elbo = self.forward_compute_elbo(
                    self.X_train[idx], None, it,
                    **self._draw_kwargs(eps, u or None))
            (-elbo).backward()
        self.optimizer.step()
        return elbo.detach()

    def _train_epoch_graphed(self, perm: torch.Tensor, noise: torch.Tensor,
                             u: Optional[List[torch.Tensor]], bs: int
                             ) -> torch.Tensor:
        # what a graph bakes in: the data's storage, the batch, the nets,
        # the optimizer, the policy and the decoder's route
        fused = getattr(self.decoder_net, "fused", None)
        key = (self.X_train.data_ptr(), tuple(self.X_train.shape), bs,
               id(self.encoder_net), id(self.decoder_net),
               id(self.optimizer), self.precision,
               fused() if callable(fused) else None)
        if self._graph is None or self._graph_key != key:
            # a private pool: the graph outlives other captures on the card
            self._graph = graphs.GraphedCall(GRAPH_WARMUP, private=True)
            self._graph_key = key
        graph = self._graph
        # the steps' counts on the card, which a replay reads
        iters = torch.arange(len(perm), device=self.device) + self.num_iter
        heads = list(zip(*u)) if u is not None else [()] * len(perm)
        elbos = []
        for idx, eps, it, u_i in zip(perm, noise, iters, heads):
            profiling.count(_STAGE_COUNTERS[graph.stage])
            with graph.stream(self.device):
                elbos.append(graph(self._graph_step, idx, eps, it, *u_i))
        return torch.stack(elbos).mean()

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

    def train_epochs_lazy(self, n: int
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``n`` epochs, each followed by its test-set evaluation when
        there is a test set: (train ELBOs (n,), test ELBOs (n,) or None),
        on the device. The JAX package runs them in one dispatch with the
        same draws, in the same order (train e0, eval e0, train e1, ...),
        and evaluation after each epoch's ``num_iter`` step; eagerly that
        is n successive epochs."""
        elbos, elbos_t = [], []
        for _ in range(n):
            elbos.append(self.train_epoch_lazy())
            if self.X_test is not None:
                elbos_t.append(self.evaluate_model_lazy())
        return (torch.stack(elbos),
                torch.stack(elbos_t) if elbos_t else None)

    def _finalize_loss_history(self) -> None:
        """Device scalars of the lazy epochs -> floats, in one copy."""
        for k, vals in self.loss_history.items():
            if vals and isinstance(vals[0], torch.Tensor):
                self.loss_history[k] = torch.stack(vals).cpu().tolist()

    def _sync_replicas(self) -> None:
        """Where ranks of the world trained a replica (the data mesh
        leaves them out, or there is none and the caller did not ask for
        ``mesh=False``), gives every rank rank 0's weights and ELBO
        history."""
        tensors = [t for part in self._state().values()
                   for t in part.values()]
        self.loss_history = sync_from_rank0(self.mesh, tensors,
                                            self.loss_history,
                                            self._mesh_pref)

    def print_statistics(self, e: int, train=None, test=None) -> None:
        """Prints epoch ``e``'s ELBOs (by default the last recorded)."""
        if train is None:
            train = self.loss_history["train_loss"][-1]
            if self.X_test is not None:
                test = self.loss_history["test_loss"][-1]
        line = "Epoch: {}/{}, Training loss: {:.4f}".format(
            e + 1, self.training_cycles, -float(train))
        if test is not None:
            line += ", Test loss: {:.4f}".format(-float(test))
        print(line)

    # --------------------------------------------------------- serialize
    def _state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"encoder": self.encoder_net.state_dict(),
                "decoder": self.decoder_net.state_dict()}

    def save_model(self, *args: str, async_write: bool = False) -> str:
        """Writes the metadict and the weights to ``<name>.aoit``;
        ``async_write`` copies the weights to the host and leaves the
        write to the background thread (flushed at the end of ``fit``)."""
        savepath = args[0] if args else self.filename
        meta = {k: v for k, v in self.metadict.items()
                if k not in ("encoder", "decoder", "optimizer")}
        if async_write:
            with profiling.span("vae.checkpoint"):
                with profiling.span("vae.checkpoint.fetch"):
                    arrays = {"params": {
                        part: {k: v.detach().cpu() for k, v in sd.items()}
                        for part, sd in self._state().items()}}
                return save_checkpoint_async(savepath, meta, arrays)
        return save_checkpoint(savepath, meta, {"params": self._state()})

    def save_weights(self, *args: str) -> str:
        savepath = args[0] if args else (self.filename + "weights")
        return save_checkpoint(savepath, {"model_type": "weights"},
                               {"params": self._state()})

    def load_arrays(self, arrays) -> None:
        """Loads a checkpoint's weights: the port's ``{"encoder",
        "decoder"}`` ``state_dict``s, or the JAX package's params (through
        ``vae_from_jax``)."""
        if is_jax_tree(arrays):
            from ..models.conversion import vae_from_jax
            enc, dec = vae_from_jax(arrays["params"], self.metadict)
        else:
            enc, dec = arrays["params"]["encoder"], arrays["params"]["decoder"]
        self.encoder_net.load_state_dict(enc)
        self.decoder_net.load_state_dict(dec)

    def load_weights(self, filepath: str) -> None:
        """Loads weights saved by :meth:`save_model` or
        :meth:`save_weights`, or by the JAX package's (a ``.aoi`` file)."""
        self.load_weights_from_arrays(load_checkpoint(filepath)[1])

    def load_weights_from_arrays(self, arrays) -> None:
        """Loads the weights of a loaded checkpoint's arrays (the port's or
        the JAX package's), initialising the nets first if need be."""
        self._init_params()
        self.load_arrays(arrays)
