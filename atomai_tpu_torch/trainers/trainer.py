"""Supervised training engine, the segmentation, im2spec, regression and
classification trainers.

Counterpart of `atomai_tpu/trainers/trainer.py:40-974` with one engine: a
Python loop of eager steps, in place of the JAX package's scan/loop pair
(which exists because XLA:CPU runs scan bodies single-threaded). What it
keeps:
- the batch schedule of `:40-47`, the same numpy draws, so a seed gives the
  JAX package's batch order;
- both epoch modes: ``full_epoch=False`` trains one scheduled minibatch a
  cycle and scores one scheduled test batch; ``full_epoch=True`` trains
  every batch in order, then scores every test batch;
- Adam(1e-3) by default, or "adam", "sgd" (no momentum) and "adamw"
  (weight decay 1e-4, optax's default; torch's is 1e-2), or a callable
  ``params -> torch.optim.Optimizer``;
- the per-step LR schedule (`:291-302`): step s takes
  ``lrs[min(s, len - 1)]``, each entry repeated per batch in full-epoch
  mode;
- SWA over the last 5 (full epoch) or 30 cycles, of parameters only;
- weight perturbation ``w += N(0, a / (1 + e)^gamma)`` every ``e_p``
  cycles, refused with BatchNorm (`:238-248, 822-834`);
- test metrics on clean (unaugmented) batches, with the net in eval mode;
- per-cycle losses kept on the device and copied to the host once per
  ``print_loss`` chunk, then printed and appended to the JSONL log;
- ``eval_model``, ``save_model(include_optimizer=...)``,
  ``resume_training``, ``train_step`` and ``test_step``.

Every random draw of a run (augmentation, dropout, perturbation) comes
from one generator on the model's device, seeded from the trainer's
:class:`GeneratorSeq`. ``plot_training_history`` writes
``<filename>_losses.png`` after a run. ``remat=True`` recomputes each
block's activations in the backward (``nets/remat.py``): bit for bit the
plain fit wherever the kernels are deterministic.

Data parallelism (`atomai_tpu/trainers/trainer.py:158-221`): in a world of
several ranks (``parallel.launch``) ``compile_trainer(mesh=None)`` builds
a data mesh sized to the largest rank count that divides the batch
(``core.mesh.resolve_data_mesh``; ``mesh=False`` opts out, a
``DeviceMesh`` is used as given, and the choice is kept across compile
calls). Every rank stages the whole data set, and in each step takes its
block of the (augmented) global batch: augmentation, dropout masks and
weight perturbations are drawn for the global batch on every rank from the
same generator; BatchNorm and the losses reduce over the global batch;
the gradients are averaged over the data axis before the optimizer step.
So every rank holds the same weights throughout, and the losses of
``loss_acc`` are the global batch's, the same on every rank. A batch the
data axis does not divide is computed whole on every rank. Not ported: the
XLA cost-analysis helpers.
"""

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..core.checkpoint import is_jax_tree, load_checkpoint, save_checkpoint
from ..core.device import resolve_device
from ..core.dtypes import default_precision
from ..core.mesh import (DATA_AXIS, axis_size, gather_blocks, mean_gradients,
                         resolve_data_mesh, shard_batch,
                         split_batch, split_mean, splits, sync_from_rank0)
from ..core.mlog import open_metrics_log
from ..core.prng import GeneratorSeq, generator_from_seed
from ..core.state import SwaState
from ..losses_metrics import iou_score, select_loss
from ..nets import (Dropout, init_cls_model, init_fcnn_model,
                    init_imspec_model, init_reg_model, init_weights_,
                    set_remat)
from ..parallel.sync_bn import global_batch_norm
from ..utils import preproc


def _shuffled_batch_schedule(n_batches: int, cycles: int, seed: int
                             ) -> np.ndarray:
    """Batch-index schedule: every batch repeated to cover ``cycles``, then
    shuffled by ``RandomState(seed)``."""
    r = cycles // n_batches
    idx = np.arange(n_batches).repeat(r + 1)[:cycles]
    rng = np.random.RandomState(seed)
    return rng.permutation(idx)


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> tensor on ``device``: floats as float32,
    integers as int64 (torch's label dtype)."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a)
    t = t.float() if t.is_floating_point() else t.long()
    return t.to(device)


class BaseTrainer:
    """Generic supervised trainer: data staged on the device as stacked
    (n_batches, batch, ...) tensors, the net, its optimizer and the cycle
    loop. Subclasses set ``self.net`` and may override :meth:`set_data`,
    :meth:`forward` and :meth:`accuracy_fn`."""

    def __init__(self, seed: int = 1, device: Any = "cuda"):
        self.device = resolve_device(device)
        self.seed = seed
        self.keys = GeneratorSeq(seed)
        self.precision = default_precision(self.device)
        self.net: Optional[nn.Module] = None
        self.criterion: Optional[Callable] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.optimizer_spec: Optional[Any] = None   # compile's ``optimizer``
        self.lrs: Optional[List[float]] = None
        self.num_steps = 0          # optimizer steps; indexes ``lrs``
        self.compute_accuracy = False
        self.full_epoch = True
        self.swa = False
        self.perturb_weights: Union[bool, Dict[str, float]] = False
        self.training_cycles = 0
        self.batch_idx_train = self.batch_idx_test = None
        self.batch_size = 1
        self.nb_classes = None
        self.Xb_train = self.yb_train = None
        self.Xb_test = self.yb_test = None
        self.data_is_set = False
        self.augment_fn: Optional[Callable] = None  # (generator, X, y)
        self.filename = "model"
        self.print_loss = 1
        self.lr_scheduler = None
        self.plot_training_history = False
        self.meta_state_dict: Dict[str, Any] = {}
        self.accuracy_metrics = None
        self.metrics_log = None
        self.running_weights_stats = None
        self.remat = False
        # the data mesh of the fit (resolved), and the caller's choice
        # (None: automatic, False: none, or a DeviceMesh), kept across
        # compile calls
        self.mesh = None
        self._mesh_pref = None
        self._reset_training_history()

    def _reset_training_history(self) -> None:
        self.loss_acc = {"train_loss": [], "test_loss": [],
                         "train_accuracy": [], "test_accuracy": []}

    # -------------------------------------------------------------- data
    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        """Splits off a test set when none is given and stages both."""
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        self._stage_batches(np.asarray(X_train, np.float32),
                            np.asarray(y_train),
                            np.asarray(X_test, np.float32),
                            np.asarray(y_test))

    def _stage_batches(self, X_train, y_train, X_test, y_test) -> None:
        def stage(a):
            return _as_tensor(np.ascontiguousarray(
                preproc.stack_batches(a, self.batch_size)), self.device)
        self.Xb_train, self.yb_train = stage(X_train), stage(y_train)
        self.Xb_test, self.yb_test = stage(X_test), stage(y_test)
        self.data_is_set = True

    def data_augmentation(self, augment_fn: Callable) -> None:
        """Sets the augmentation, ``augment_fn(generator, X, y) -> (X,
        y)`` on the device's batches."""
        self.augment_fn = augment_fn

    # ----------------------------------------------------------- compile
    def get_loss_fn(self, loss: Union[str, Callable], nb_classes=None
                    ) -> Callable:
        """The loss function of ``loss`` (a name or a callable)."""
        return select_loss(loss, nb_classes)

    def compile_trainer(self, train_data: Optional[Tuple] = None,
                        loss: Union[str, Callable] = "ce",
                        optimizer: Optional[Any] = None,
                        training_cycles: int = 1000,
                        batch_size: int = 32,
                        compute_accuracy: bool = False,
                        full_epoch: bool = False,
                        swa: bool = False,
                        perturb_weights: Union[bool, Dict] = False,
                        **kwargs) -> None:
        """Stages the data and sets up the optimizer, the loss, the batch
        schedule, the logging and the data mesh (``mesh``: None for the
        automatic one, False for none, or a ``DeviceMesh``; the JAX
        package's contract)."""
        pref = kwargs.get("mesh", self._mesh_pref)
        self.mesh = resolve_data_mesh(pref, batch_size)
        self._mesh_pref = pref
        # kept across compile calls, as in the JAX package
        self.remat = bool(kwargs.get("remat", self.remat))
        if self.net is not None:
            set_remat(self.net, self.remat)
        self.full_epoch = full_epoch
        self.training_cycles = training_cycles
        self.batch_size = batch_size
        self.compute_accuracy = compute_accuracy
        self.swa = swa
        self.lr_scheduler = kwargs.get("lr_scheduler")
        self.plot_training_history = kwargs.get("plot_training_history",
                                                False)
        if self.data_is_set:
            if kwargs.get("overwrite_train_data", True) and \
                    train_data is not None:
                self.set_data(*train_data, **kwargs)
        else:
            if train_data is None:
                raise ValueError("Provide training data")
            self.set_data(*train_data, **kwargs)

        self.optimizer_spec = optimizer
        self.perturb_weights = perturb_weights
        if self.perturb_weights:
            if self.meta_state_dict.get("batchnorm",
                                        self.meta_state_dict.get(
                                            "batch_norm", False)):
                raise AssertionError(
                    "To use time-dependent weights perturbation, "
                    "turn off the batch normalization layers")
            if isinstance(self.perturb_weights, bool):
                e_p = 1 if self.full_epoch else 50
                self.perturb_weights = {"a": .01, "gamma": 1.5, "e_p": e_p}

        if self.optimizer is None:
            self.optimizer = self._make_optimizer(optimizer)
        if self.criterion is None:
            self.criterion = select_loss(loss, self.nb_classes)
        if not self.full_epoch:
            batch_seed = kwargs.get(
                "batch_seed", getattr(self, "batch_seed", self.seed))
            self.batch_idx_train = _shuffled_batch_schedule(
                len(self.Xb_train), training_cycles, batch_seed)
            self.batch_idx_test = _shuffled_batch_schedule(
                len(self.Xb_test), training_cycles, batch_seed)
        self.print_loss = kwargs.get("print_loss")
        if self.print_loss is None:
            self.print_loss = 100 if not self.full_epoch else 1
        self.accuracy_metrics = kwargs.get("accuracy_metrics")
        self.metrics_log = kwargs.get("metrics_log")
        self.filename = kwargs.get("filename", "./model")

    def _make_optimizer(self, optimizer) -> torch.optim.Optimizer:
        params = self.net.parameters()
        self.lrs = None
        if optimizer is not None and not isinstance(optimizer, str):
            return optimizer(params)      # a given optimizer keeps its LR
        if self.lr_scheduler is not None:
            lrs = np.asarray(self.lr_scheduler, np.float32)
            if self.full_epoch:
                lrs = np.repeat(lrs, max(len(self.Xb_train), 1))
            self.lrs = [float(v) for v in lrs]
        lr = self.lrs[0] if self.lrs else 1e-3
        name = optimizer or "adam"
        if name == "adam":
            return torch.optim.Adam(params, lr=lr, eps=1e-8)
        if name == "adamw":
            return torch.optim.AdamW(params, lr=lr, eps=1e-8,
                                     weight_decay=1e-4)
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        raise ValueError(f"Unknown optimizer '{name}': use 'adam', 'sgd', "
                         "'adamw' or a callable params -> optimizer")

    # ------------------------------------------------------------ engine
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """The net's output for a staged batch, under the precision
        policy; subclasses adapt the layout."""
        with self.precision.scope(self.device):
            return self.net(X)

    def accuracy_fn(self, y: torch.Tensor, y_prob: torch.Tensor
                    ) -> torch.Tensor:
        """Accuracy metric as a device scalar; subclasses implement."""
        raise NotImplementedError

    def _has_accuracy(self) -> bool:
        return bool(self.compute_accuracy) and \
            type(self).accuracy_fn is not BaseTrainer.accuracy_fn

    def _set_dropout_generator(self, g: Optional[torch.Generator]) -> None:
        for m in self.net.modules():
            if isinstance(m, Dropout):
                m.generator = g

    def _splits(self, X) -> bool:
        """Whether this rank computes its block of the batch ``X``."""
        return splits(self.mesh, DATA_AXIS) and \
            len(X) % axis_size(self.mesh, DATA_AXIS) == 0

    def _loss(self, out, y, split: bool) -> torch.Tensor:
        """The criterion over the global batch: a loss that is a mean of
        per-element terms is averaged over the ranks, one that reduces
        over the global batch itself (``batch_global``) is taken as it
        is."""
        loss = self.criterion(out, y)
        if split and not getattr(self.criterion, "batch_global", False):
            loss = split_mean(loss)
        return loss

    def _step_outputs(self, X, y, split: bool):
        """(the net's output of this rank's rows, their targets)."""
        if split:
            X, y = shard_batch(self.mesh, X, y)
        return self.forward(X), y

    def _train_batch(self, X, y):
        """One optimizer step on the global batch (X, y), of which this
        rank computes its block under a data mesh; (loss, accuracy or
        None), on the device."""
        self.net.train()
        self.optimizer.zero_grad(set_to_none=True)
        split = self._splits(X)
        with self.precision.tf32_scope(), split_batch(
                self.mesh if split else None), global_batch_norm(self.net):
            out, y_rows = self._step_outputs(X, y, split)
            loss = self._loss(out, y_rows, split)
            loss.backward()    # the backward's convs under TF32 too
        mean_gradients(self.net.parameters(), self.mesh)
        if self.lrs is not None:
            lr = self.lrs[min(self.num_steps, len(self.lrs) - 1)]
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.num_steps += 1
        acc = self._accuracy(y, out.detach(), split)
        return loss.detach(), acc

    def _accuracy(self, y, out, split: bool):
        """The accuracy of the global batch (the ranks' outputs gathered)."""
        if not self._has_accuracy():
            return None
        return self.accuracy_fn(y, gather_blocks(out, self.mesh, DATA_AXIS)
                                if split else out)

    @torch.no_grad()
    def _eval_batch(self, X, y):
        self.net.eval()
        split = self._splits(X)
        with split_batch(self.mesh if split else None):
            out, y_rows = self._step_outputs(X, y, split)
            loss = self._loss(out, y_rows, split)
        return loss, self._accuracy(y, out, split)

    def _augmented(self, X, y, g):
        if self.augment_fn is None:
            return X, y
        return self.augment_fn(g, X, y)

    def _cycle(self, e: int, g: torch.Generator, swa: Optional[SwaState],
               swa_start: int) -> List[Optional[torch.Tensor]]:
        """One training cycle; [train loss, test loss, train acc, test
        acc] as device scalars (accuracies None when off)."""
        if not self.full_epoch:
            bi, bt = int(self.batch_idx_train[e]), int(self.batch_idx_test[e])
            tr = [self._train_batch(*self._augmented(
                self.Xb_train[bi], self.yb_train[bi], g))]
            ts = [self._eval_batch(self.Xb_test[bt], self.yb_test[bt])]
        else:
            tr = [self._train_batch(*self._augmented(
                self.Xb_train[i], self.yb_train[i], g))
                for i in range(len(self.Xb_train))]
            ts = [self._eval_batch(self.Xb_test[i], self.yb_test[i])
                  for i in range(len(self.Xb_test))]
        if swa is not None and e >= swa_start:
            swa.update(dict(self.net.named_parameters()))
        if self.perturb_weights:
            self._perturb(e, g)

        def mean(vals):
            if len(vals) == 1 or vals[0] is None:
                return vals[0]
            return sum(vals) / len(vals)
        return [mean([t[0] for t in tr]), mean([t[0] for t in ts]),
                mean([t[1] for t in tr]), mean([t[1] for t in ts])]

    @torch.no_grad()
    def _perturb(self, e: int, g: torch.Generator) -> None:
        """Adds N(0, a / (1 + e)^gamma) to every parameter every ``e_p``
        cycles."""
        cfg = self.perturb_weights
        if (e + 1) % cfg["e_p"] != 0:
            return
        sd = math.sqrt(cfg["a"] / (1.0 + e) ** cfg["gamma"])
        for p in self.net.parameters():
            p.add_(torch.randn(p.shape, generator=g, device=p.device,
                               dtype=p.dtype), alpha=sd)

    def run(self) -> nn.Module:
        """Trains for ``training_cycles`` cycles, then applies SWA,
        evaluates and saves ``<filename>_metadict_final``."""
        if self.optimizer is None:
            raise RuntimeError("Compile the trainer before running it")
        cycles = self.training_cycles
        chunk = max(1, min(self.print_loss, cycles))
        swa = SwaState(dict(self.net.named_parameters())) \
            if self.swa else None
        swa_start = max(cycles - (5 if self.full_epoch else 30), 0)
        g = self.keys.next(device=self.device)
        self._set_dropout_generator(g)
        mlog = open_metrics_log(self.metrics_log)
        try:
            pending = []
            for e in range(cycles):
                pending.append(self._cycle(e, g, swa, swa_start))
                if len(pending) == chunk or e == cycles - 1:
                    self._record(e + 1 - len(pending), pending, mlog)
                    pending = []
        finally:
            self._set_dropout_generator(None)
            if mlog is not None:
                mlog.close()
        if swa is not None:
            print("Performing stochastic weight averaging...")
            mean = swa.mean()
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    p.copy_(mean[k])
            self.running_weights_stats = (mean, swa.variance())
        self._sync_replicas()
        self.net.eval()
        self.eval_model()
        self.save_model(self.filename + "_metadict_final")
        if self.plot_training_history:
            from ..utils.viz import plot_losses
            plot_losses(self.loss_acc["train_loss"],
                        self.loss_acc["test_loss"],
                        savefig=self.filename + "_losses.png")
        return self.net

    def fit(self) -> nn.Module:
        """:meth:`run` (the JAX package's alias)."""
        return self.run()

    def _sync_replicas(self) -> None:
        """Where ranks of the world trained a replica on the whole
        batches (the data mesh leaves them out, or there is none and the
        caller did not ask for ``mesh=False``), gives every rank rank 0's
        weights, BatchNorm statistics, SWA moments and history."""
        tensors = list(self.net.state_dict().values())
        if self.running_weights_stats is not None:
            tensors += [t for part in self.running_weights_stats
                        for t in part.values()]
        self.loss_acc = sync_from_rank0(self.mesh, tensors, self.loss_acc,
                                        self._mesh_pref)

    def select_lr(self, e: int) -> None:
        """Nothing: the per-step schedule is set at compile time (kept for
        the JAX package's and the original atomai's API)."""

    def _record(self, e0: int, rows: List[List], mlog) -> None:
        """Copies a chunk's device scalars to the host in one transfer,
        appends them to ``loss_acc`` and the log, and prints."""
        n_cols = 4 if self._has_accuracy() else 2
        vals = torch.stack([torch.stack(r[:n_cols]) for r in rows])
        vals = vals.cpu().numpy().astype(np.float64)
        names = ["train_loss", "test_loss", "train_accuracy",
                 "test_accuracy"][:n_cols]
        for j, k in enumerate(names):
            self.loss_acc[k].extend(vals[:, j].tolist())
        if mlog is not None:
            mlog.log_many(e0, **{k: vals[:, j] for j, k in
                                 enumerate(names)})
        self.print_statistics(e0 + len(rows) - 1)

    # ----------------------------------------------------- one-off steps
    def train_step(self, feat, tar) -> Tuple[float, ...]:
        """One optimizer step on one batch (no augmentation); Adam(1e-3)
        and MSE when nothing was compiled."""
        if self.optimizer is None:
            self.optimizer = torch.optim.Adam(self.net.parameters(),
                                              lr=1e-3, eps=1e-8)
        if self.criterion is None:
            self.criterion = select_loss("mse")
        loss, acc = self._train_batch(_as_tensor(feat, self.device),
                                      _as_tensor(tar, self.device))
        return (float(loss),) if acc is None else (float(loss), float(acc))

    def test_step(self, feat, tar) -> Tuple[float, ...]:
        """Loss (and accuracy) of one batch in eval mode."""
        loss, acc = self._eval_batch(_as_tensor(feat, self.device),
                                     _as_tensor(tar, self.device))
        return (float(loss),) if acc is None else (float(loss), float(acc))

    def eval_model(self) -> None:
        """Prints the loss (and accuracy) of the final weights over the
        whole test set."""
        res = [self._eval_batch(self.Xb_test[i], self.yb_test[i])
               for i in range(len(self.Xb_test))]
        losses = torch.stack([r[0] for r in res]).cpu().numpy()
        print("Model (final state) evaluation loss:",
              np.around(np.mean(losses), 4))
        if self._has_accuracy():
            accs = torch.stack([r[1] for r in res]).cpu().numpy()
            print("Model (final state) accuracy:",
                  np.around(np.mean(accs), 4))

    def print_statistics(self, e: int, **kwargs) -> None:
        accuracy_metrics = self.accuracy_metrics or "Accuracy"
        msg = "Epoch {}/{} ...".format(e + 1, self.training_cycles)
        msg += " Training loss: {} ...".format(
            np.around(self.loss_acc["train_loss"][-1], 4))
        msg += " Test loss: {}".format(
            np.around(self.loss_acc["test_loss"][-1], 4))
        if self._has_accuracy() and self.loss_acc["train_accuracy"]:
            msg += " ... Train {}: {} ... Test {}: {}".format(
                accuracy_metrics,
                np.around(self.loss_acc["train_accuracy"][-1], 4),
                accuracy_metrics,
                np.around(self.loss_acc["test_accuracy"][-1], 4))
        print(msg)

    # --------------------------------------------------------- serialize
    def save_model(self, *args: str, include_optimizer: bool = False
                   ) -> str:
        """Writes the metadict and the net's ``state_dict`` (BatchNorm
        statistics included) to ``<name>.aoit``; ``include_optimizer``
        adds the optimizer state and the step counters, for
        :meth:`resume_training`."""
        filename = args[0] if args else self.filename
        meta = {k: v for k, v in self.meta_state_dict.items()
                if k not in ("weights", "optimizer")}
        arrays = {"params": self.net.state_dict()}
        if include_optimizer and self.optimizer is not None:
            arrays["opt_state"] = self.optimizer.state_dict()["state"]
            meta["completed_cycles"] = len(self.loss_acc["train_loss"])
            meta["optimizer_steps"] = self.num_steps
        return save_checkpoint(filename, meta, arrays)

    #: The model's weight bridge, ``(params, batch_stats, metadict) ->
    #: state_dict`` from the JAX package's variables (set by the models).
    jax_bridge: Optional[Callable] = None

    def load_jax_variables(self, params: Any, batch_stats: Any = None
                           ) -> None:
        """Loads the JAX net's variables (nested dicts of numpy arrays)
        through the model's weight bridge; afterwards both packages
        compute the same function."""
        if self.jax_bridge is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no weight bridge from JAX")
        self.net.load_state_dict(self.jax_bridge(
            params, batch_stats, self.meta_state_dict), strict=True)

    def load_arrays(self, arrays: Dict[str, Any]) -> None:
        """Loads a checkpoint's weights: the port's ``state_dict``
        (``arrays["params"]``) or the JAX package's ``params`` and
        ``batch_stats``."""
        if is_jax_tree(arrays):
            self.load_jax_variables(arrays["params"],
                                    arrays.get("batch_stats"))
        else:
            self.net.load_state_dict(arrays["params"])

    def load_weights(self, filepath: str) -> None:
        """Loads the weights of a ``.aoit`` file written by
        :meth:`save_model`, or of the JAX package's ``.aoi`` file of the
        same model."""
        self.load_arrays(load_checkpoint(filepath)[1])

    def _jax_optimizer_state(self, arrays: Dict[str, Any]
                             ) -> Dict[int, Dict[str, torch.Tensor]]:
        """torch's optimizer state from the JAX package's optax state
        (flax state-dict form): Adam's ``count``, ``mu`` and ``nu`` become
        each parameter's ``step``, ``exp_avg`` and ``exp_avg_sq``, the
        moments relaid out as the weights are (through the weight bridge,
        with the checkpoint's BatchNorm statistics alongside); an SGD
        without momentum has no state."""
        chain = arrays["opt_state"]
        adam = [chain[k] for k in sorted(chain, key=int)
                if isinstance(chain[k], dict) and "mu" in chain[k]]
        if not adam:
            if isinstance(self.optimizer, (torch.optim.Adam,
                                           torch.optim.AdamW)):
                raise ValueError("the checkpoint's optimizer state holds no "
                                 "Adam moments")
            return {}
        bs = arrays.get("batch_stats")
        mu, nu = (self.jax_bridge(adam[0][k], bs, self.meta_state_dict)
                  for k in ("mu", "nu"))
        step = torch.tensor(float(np.asarray(adam[0]["count"])))
        return {i: {"step": step.clone(), "exp_avg": mu[name],
                    "exp_avg_sq": nu[name]}
                for i, (name, _) in enumerate(self.net.named_parameters())}

    def resume_training(self, filepath: str,
                        additional_cycles: Optional[int] = None) -> None:
        """Restores the weights and the optimizer state of a checkpoint
        saved with ``include_optimizer=True`` (a ``.aoit`` of the port, or
        a ``.aoi`` of the JAX package with its optax Adam state, JAX
        `trainer.py:766-800`) into the compiled trainer and trains on, for
        ``additional_cycles`` (default: the compiled ``training_cycles``);
        the batch schedule goes on from the file's ``completed_cycles``."""
        meta, arrays = load_checkpoint(filepath)
        if "opt_state" not in arrays:
            raise ValueError(
                "Checkpoint has no optimizer state; save with "
                "save_model(..., include_optimizer=True) to resume")
        if self.optimizer is None:
            raise RuntimeError("Compile the trainer before resuming")
        self.load_arrays(arrays)
        state = self.optimizer.state_dict()
        if is_jax_tree(arrays):
            state["state"] = self._jax_optimizer_state(arrays)
            steps = [int(v["step"]) for v in state["state"].values()]
            self.num_steps = int(meta.get("optimizer_steps",
                                          steps[0] if steps else 0))
        else:
            state["state"] = arrays["opt_state"]
            self.num_steps = int(meta.get("optimizer_steps", 0))
        self.optimizer.load_state_dict(state)
        if additional_cycles is not None:
            self.training_cycles = additional_cycles
            if not self.full_epoch:
                seed = int(meta.get("completed_cycles", 0)) + 1
                self.batch_idx_train = _shuffled_batch_schedule(
                    len(self.Xb_train), additional_cycles, seed)
                self.batch_idx_test = _shuffled_batch_schedule(
                    len(self.Xb_test), additional_cycles, seed)
        self.run()


class SegTrainer(BaseTrainer):
    """Semantic segmentation trainer (counterpart of
    `atomai_tpu/trainers/trainer.py:837-877`).

    The net ("Unet", "dilnet", "SegResNet", "ResHedNet", or a user's
    ``nn.Module`` from NCHW images to NCHW logits, which keeps its own
    weights) is built, and its weights drawn from ``seed``, at
    construction (the JAX package draws them when it compiles). Keyword
    args: ``seed`` (default 1), ``batch_seed`` (default ``seed``),
    ``device`` ("cuda", the default, raises without a card; "cpu" when
    asked for), and the net's.
    """

    def __init__(self, model: Union[str, nn.Module] = "Unet",
                 nb_classes: int = 1, **kwargs: Any):
        seed = kwargs.get("seed", 1)
        super().__init__(seed=seed, device=kwargs.get("device", "cuda"))
        self.batch_seed = kwargs.get("batch_seed", seed)
        self.nb_classes = nb_classes
        self.net, self.meta_state_dict = init_fcnn_model(
            model, nb_classes, **kwargs)
        if isinstance(model, str):   # a user's module keeps its weights
            init_weights_(self.net, generator_from_seed(seed))
        self.net.to(self.device).eval()

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        """NHWC float32 images and (n, h, w) masks (float32 for one class,
        int64 for several); checks the class count against the net's."""
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        nb_classes = preproc.num_classes_from_labels(np.asarray(y_train))
        data = preproc.check_image_dims(X_train, y_train, X_test, y_test,
                                        nb_classes)
        if self.nb_classes != nb_classes:
            raise AssertionError("Number of classes in initialized model "
                                 "is different from the number of classes "
                                 "contained in training data")
        self._stage_batches(*preproc.cast_image_arrays(*data, nb_classes))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """NHWC batch -> channel-last float32 logits (the Unet is NCHW)."""
        with self.precision.scope(self.device):
            out = self.net(X.permute(0, 3, 1, 2))
        return out.float().permute(0, 2, 3, 1)

    def accuracy_fn(self, y: torch.Tensor, y_prob: torch.Tensor
                    ) -> torch.Tensor:
        """IoU of the batch."""
        return iou_score(y, y_prob)


class ImSpecTrainer(BaseTrainer):
    """Image <-> spectrum trainer (counterpart of
    `atomai_tpu/trainers/trainer.py:880-909`).

    The net is built, and its weights drawn from ``seed``, at
    construction. Keyword args: ``seed`` (default 1), ``batch_seed``
    (default ``seed``), ``device`` ("cuda", the default, raises without a
    card; "cpu" when asked for), and ``init_imspec_model``'s.
    """

    def __init__(self, in_dim: Tuple[int, ...], out_dim: Tuple[int, ...],
                 latent_dim: int = 2, **kwargs: Any):
        seed = kwargs.get("seed", 1)
        super().__init__(seed=seed, device=kwargs.get("device", "cuda"))
        self.batch_seed = kwargs.get("batch_seed", seed)
        self.in_dim, self.out_dim = tuple(in_dim), tuple(out_dim)
        self.net, self.meta_state_dict = init_imspec_model(
            in_dim, out_dim, latent_dim, **kwargs)
        init_weights_(self.net, generator_from_seed(seed))
        self.net.to(self.device).eval()

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        """(image, spectrum) pairs, either way round: a singleton channel
        axis is squeezed, and the inputs must have the net's ``in_dim``."""
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        X_train, y_train, X_test, y_test = preproc.check_signal_dims(
            X_train, y_train, X_test, y_test)
        if X_train.shape[1:] != ((1,) + self.in_dim) and \
                X_train.shape[1:] != self.in_dim:
            raise AssertionError(
                "The input/output dimensions of the model must match "
                "the height, width and length (for spectra) of training")
        self._stage_batches(*(np.asarray(a, np.float32) for a in
                              (X_train, y_train, X_test, y_test)))


class _ImageTrainer(BaseTrainer):
    """Shared by the regression and classification trainers: an image net
    built at construction with its weights drawn from ``seed``, NHWC
    batches fed to it as NCHW, the given or the default split (test_size
    0.15)."""

    def __init__(self, init_model: Callable, out: Any, backbone: str,
                 **kwargs: Any):
        seed = kwargs.get("seed", 1)
        super().__init__(seed=seed, device=kwargs.get("device", "cuda"))
        self.batch_seed = kwargs.get("batch_seed", seed)
        self.net, self.meta_state_dict = init_model(
            out, backbone, kwargs.get("input_channels", 1))
        init_weights_(self.net, generator_from_seed(seed))
        self.net.to(self.device).eval()

    def _images(self, *arrays) -> List[np.ndarray]:
        return [preproc.as_channel_last_images(np.asarray(a, np.float32))
                for a in arrays]

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """NHWC batch -> the net's float32 output."""
        with self.precision.scope(self.device):
            out = self.net(X.permute(0, 3, 1, 2))
        return out.float()


class RegTrainer(_ImageTrainer):
    """Image -> vector regression trainer (counterpart of
    `atomai_tpu/trainers/trainer.py:911-941`): 1-D targets become (n, 1).
    Keyword args: ``seed``, ``batch_seed``, ``device`` (as
    :class:`SegTrainer`'s) and ``input_channels`` (default 1)."""

    def __init__(self, out_dim: int = 1, backbone: str = "mobilenet",
                 **kwargs: Any):
        super().__init__(init_reg_model, out_dim, backbone, **kwargs)
        self.out_dim = out_dim

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        X_train, X_test = self._images(X_train, X_test)
        y_train, y_test = (np.asarray(y, np.float32) for y in
                           (y_train, y_test))
        y_train, y_test = (y[:, None] if y.ndim == 1 else y for y in
                           (y_train, y_test))
        self._stage_batches(X_train, y_train, X_test, y_test)


class clsTrainer(_ImageTrainer):
    """Image classification trainer (counterpart of
    `atomai_tpu/trainers/trainer.py:943-974`): integer labels, log-softmax
    outputs, accuracy the share of argmax matches. Keyword args as
    :class:`RegTrainer`'s."""

    def __init__(self, nb_classes: int = 1, backbone: str = "mobilenet",
                 **kwargs: Any):
        super().__init__(init_cls_model, nb_classes, backbone, **kwargs)
        self.nb_classes = nb_classes

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        X_train, X_test = self._images(X_train, X_test)
        self._stage_batches(X_train, np.asarray(y_train, np.int64).reshape(-1),
                            X_test, np.asarray(y_test, np.int64).reshape(-1))

    def accuracy_fn(self, y: torch.Tensor, y_prob: torch.Tensor
                    ) -> torch.Tensor:
        """The share of argmax predictions that equal the labels."""
        return (y_prob.argmax(-1) == y.long()).float().mean()
