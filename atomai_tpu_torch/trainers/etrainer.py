"""Deep-ensemble training.

Counterpart of `atomai_tpu/trainers/etrainer.py:37-663`: members trained
from scratch (distinct initial weights), from a baseline (short fine-tunes
of one trained net, whose mean is the final model), and SWAG (weights
sampled from the running moments of one SWA run). What the JAX engine
fixes, this one keeps:
- member i's batch order is ``_shuffled_batch_schedule(nb, cycles, i +
  seed_offset)``, seed_offset 0 from scratch and 2 from a baseline
  (`:202-204, 441, 474`); one scheduled batch a cycle;
- each member has its own optimizer, built as the single-model trainer's
  (`:166, 198`);
- SWA over the last ``min(30, cycles)`` cycles, the parameters' sum over
  that count (`:219, 316-321, 390-392`);
- each member keeps its own BatchNorm statistics: a member is the net's
  whole ``state_dict`` (`:505-535`); SWAG samples share the baseline's
  (`:494-500`);
- from a baseline, the final model's parameters are the members' mean
  (`:480`); otherwise the final model is the last member.

``member_layout`` (`:144-158`): "map" runs the members one after another
on the single-model step; "vmap" runs every member's step as one
``torch.func.vmap`` over the members' stacked weights (`:161-271,
348-351`), with BatchNorm as ``nets.functional_bn.VmapBatchNorm`` and
the precision policy's autocast applied inside the vmap
(``autocast_in_vmap``, which vmap needs), one
optimizer over the stacked leaves (Adam, AdamW or SGD, which act element
by element, so each member's own) and, with ``remat``, each block
checkpointed inside the vmap (``nets.remat``). "auto" is the loop
(``AUTO_LAYOUT``). Initial weights of members from scratch come from
``init_weights_`` with one generator a member off the trainer's
:class:`GeneratorSeq`; every random draw of member i's training
(augmentation, dropout) from a generator of its own on the device, in
either layout in the same order, so the two layouts train the same
members.

Members over the model axis (`:112-141, 205-230`): in a world of several
ranks, ``compile_ensemble_trainer(mesh=None)`` spreads the members over an
:func:`~atomai_tpu_torch.core.mesh.ensemble_mesh` (``mesh=False``: every
rank trains every member; a ``DeviceMesh`` is used as given). Each rank
trains its contiguous block of members in the layout above; every rank
still draws all ``n_models`` initial and run generators, so member i is
the same net whichever rank trains it. The members' ``state_dict``s and
losses are then broadcast from their owners, so that every rank returns
the whole ensemble (a rank outside the mesh trains none). The baseline and
SWAG fits have no member axis and take the automatic data mesh unless
``mesh=False`` (`:398-428`).
"""

import copy
import warnings
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call, vmap

from ..core.checkpoint import save_checkpoint
from ..core.mesh import (MODEL_AXIS, axis_size, block, block_owner,
                         broadcast_tensors, in_mesh, replicas,
                         resolve_model_mesh)
from ..core.prng import GeneratorSeq, generator_from_seed
from ..core.state import SwaState
from ..losses_metrics import iou_score
from ..nets import init_fcnn_model, init_imspec_model, init_weights_
from ..nets.functional_bn import (MaskedDropout, autocast_in_vmap,
                                  vmappable)
from ..utils import preproc
from ..utils.nn import sample_weights
from .trainer import BaseTrainer, _shuffled_batch_schedule

# member_layout "auto": the loop, which an H100 80GB HBM3 (700 W) ran at
# 244-367 images/s on config D against the vmap's 173-183, at a seventh of
# its peak memory (chip_smoke.py's ensemble_vmap_path; PERF.md)
AUTO_LAYOUT = "map"
# optimizers that act element by element, so that one of them over the
# stacked members' leaves is each member's own
_ELEMENTWISE = (torch.optim.Adam, torch.optim.AdamW, torch.optim.SGD)

State = Dict[str, torch.Tensor]


def _clone(state: Mapping[str, torch.Tensor]) -> State:
    return {k: v.detach().clone() for k, v in state.items()}


class _TrainerForward(nn.Module):
    """The trainer's :meth:`forward` of its net as a module, so that
    ``functional_call`` on it swaps the net's (``net.*``) tensors."""

    def __init__(self, trainer: BaseTrainer):
        super().__init__()
        self.net = trainer.net
        self._forward = trainer.forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x)


def _dropout_shapes(trainer: BaseTrainer, drops, x: torch.Tensor):
    """The input shape of each of ``drops`` ((name, MaskedDropout) of
    ``trainer.net``) in a forward of the trainer on one member's batch
    ``x``, in ``drops``' order; each must run once a forward. The forward
    runs once, on an eval-mode copy of the net (no statistic moves)."""
    seen: Dict[str, List] = {n: [] for n, _ in drops}
    net = trainer.net
    trainer.net = probe = copy.deepcopy(net).eval()
    for n, _ in drops:
        probe.get_submodule(n).register_forward_pre_hook(
            lambda mod, inp, n=n: seen[n].append(tuple(inp[0].shape)))
    try:
        with torch.no_grad():
            trainer.forward(x)
    finally:
        trainer.net = net
    if any(len(v) != 1 for v in seen.values()):
        raise NotImplementedError(
            "member_layout='vmap' draws one dropout mask a layer a step: "
            "a Dropout layer that runs other than once a forward needs "
            "member_layout='map'")
    return [seen[n][0] for n, _ in drops]


class BaseEnsembleTrainer(BaseTrainer):
    """Deep-ensemble engine on top of :class:`BaseTrainer`. ``model`` (an
    ``nn.Module``) is the skeleton every member copies. Keyword args:
    ``seed`` (default 1), ``device`` ("cuda", the default; "cpu" when asked
    for)."""

    def __init__(self, model: Optional[nn.Module] = None,
                 nb_classes: Optional[int] = None, **kwargs: Any):
        super().__init__(seed=kwargs.get("seed", 1),
                         device=kwargs.get("device", "cuda"))
        if model is not None:
            self.net = model.to(self.device)
            self.nb_classes = nb_classes
        self.ensemble_state_dict: Dict[int, State] = {}
        self.kdict: Dict[str, Any] = {}
        self.member_schedules: Optional[np.ndarray] = None
        # the caller's member mesh (None: automatic, False: none, or a
        # DeviceMesh); apart from BaseTrainer.mesh, the baseline's
        self.member_mesh = None

    def compile_ensemble_trainer(self, **kwargs: Any) -> None:
        """Stores the training kwargs (``fit``'s, plus ``member_layout``:
        "auto", "map" or "vmap"; ``remat`` as the single-model trainer's,
        each member a copy of the rematerialised net; ``mesh``: the member
        mesh, None for the automatic one, False for none, which also keeps
        the baseline fit off the automatic data mesh)."""
        self.member_mesh = kwargs.pop("mesh", None)
        self.kdict = kwargs
        self.full_epoch = self.kdict.get("full_epoch", False)
        self.batch_size = self.kdict.get("batch_size", 32)
        self.kdict["overwrite_train_data"] = False
        self._member_layout()

    def _resolve_mesh(self, n_models: int):
        """The mesh the members spread over (or None)."""
        return resolve_model_mesh(self.member_mesh, n_models)

    def _member_layout(self) -> str:
        """"map" (the members one after another) or "vmap" (one
        ``torch.func.vmap`` of the step over the stacked members); "auto"
        is ``AUTO_LAYOUT``."""
        layout = self.kdict.get("member_layout", "auto")
        if layout not in ("auto", "map", "vmap"):
            raise ValueError("member_layout must be 'auto'|'map'|'vmap'")
        return AUTO_LAYOUT if layout == "auto" else layout

    # ------------------------------------------------------------ engine
    def _train_members(self, n_models: int, cycles: int,
                       from_state: Optional[State] = None,
                       augment_fn=None, seed_offset: int = 0,
                       swa: bool = False) -> List[State]:
        """Trains ``n_models`` members, this rank's block of them over the
        member mesh, in the member layout; returns every member's
        ``state_dict`` (each from the rank that trained it) and appends
        the members' mean loss of each cycle to
        ``loss_acc["train_loss"]``."""
        layout = self._member_layout()
        nb = len(self.Xb_train)
        self.member_schedules = np.stack([
            _shuffled_batch_schedule(nb, cycles, i + seed_offset)
            for i in range(n_models)])
        init_gens = self.keys.next(n_models) if from_state is None else None
        run_gens = self.keys.next(n_models, device=self.device)
        swa_start = cycles - min(30, cycles)
        mesh = self._resolve_mesh(n_models)
        owned = range(n_models)[block(n_models, mesh, MODEL_AXIS)] \
            if mesh is None or in_mesh(mesh) else range(0)
        saved = (self.net, self.optimizer, self.num_steps, self.augment_fn,
                 self.compute_accuracy, self.mesh)
        try:
            self.augment_fn = augment_fn
            self.compute_accuracy = False
            self.mesh = None          # members see whole batches
            members = []
            for i in owned:
                net = copy.deepcopy(saved[0])
                if from_state is None:
                    init_weights_(net, init_gens[i])
                else:
                    net.load_state_dict(from_state)
                members.append(net)
            train = self._vmap_members if layout == "vmap" \
                else self._map_members
            states, losses = train(dict(zip(owned, members)), run_gens,
                                   swa, swa_start)
        finally:
            (self.net, self.optimizer, self.num_steps, self.augment_fn,
             self.compute_accuracy, self.mesh) = saved
        if mesh is not None or replicas(None, self.member_mesh):
            self._gather_members(mesh, n_models, cycles, states, losses)
        states = [states[i] for i in range(n_models)]
        self.loss_acc["train_loss"].extend(torch.stack(
            [losses[i] for i in range(n_models)]).mean(0).cpu().tolist())
        return states

    def _map_members(self, members: Dict[int, nn.Module], run_gens,
                     swa: bool, swa_start: int):
        """The "map" layout: each member's cycles on the single-model step,
        one member after another. ({member: state_dict}, {member: (cycles,)
        losses})."""
        states, losses = {}, {}
        for i, net in members.items():
            self.net = net
            self.optimizer = self._make_optimizer(self.optimizer_spec)
            self.num_steps = 0
            g = run_gens[i]
            self._set_dropout_generator(g)
            avg = SwaState(dict(net.named_parameters())) if swa else None
            member_losses = []
            for e, bi in enumerate(self.member_schedules[i]):
                loss, _ = self._train_batch(*self._augmented(
                    self.Xb_train[int(bi)], self.yb_train[int(bi)], g))
                member_losses.append(loss)
                if avg is not None and e >= swa_start:
                    avg.update(dict(net.named_parameters()))
            self._set_dropout_generator(None)
            if avg is not None:
                with torch.no_grad():
                    for k, p in avg.mean().items():
                        net.get_parameter(k).copy_(p)
            states[i] = _clone(net.state_dict())
            losses[i] = torch.stack(member_losses)
        return states, losses

    def _vmap_members(self, members: Dict[int, nn.Module], run_gens,
                      swa: bool, swa_start: int):
        """The "vmap" layout (counterpart of `etrainer.py:161-271, 348-351`):
        the members' parameters and buffers stacked on a leading axis, each
        cycle one ``torch.func.vmap`` of ``functional_call`` over them, the
        members' losses summed and differentiated by autograd on the
        stacked leaves, one optimizer over those (element by element, so
        each member's own). Outside the vmap, each member's batch is
        augmented, and its dropout masks drawn, from its own generator in
        the loop's order, so the inputs are the loop's draw for draw.
        BatchNorm runs as :class:`VmapBatchNorm`, which updates the stacked
        running statistics in place. Returns what :meth:`_map_members`
        returns."""
        if not members:
            return {}, {}
        order = list(members)
        skeleton = next(iter(members.values()))
        self.net = vmappable(copy.deepcopy(skeleton)).train()
        call = _TrainerForward(self)
        params = {"net." + k: torch.stack(
            [m.get_parameter(k).detach() for m in members.values()]
        ).requires_grad_() for k, _ in skeleton.named_parameters()}
        buffers = {"net." + k: torch.stack(
            [m.get_buffer(k) for m in members.values()])
            for k, _ in skeleton.named_buffers()}
        keys = list(skeleton.state_dict())
        del members, skeleton
        self.optimizer = self._make_optimizer(self.optimizer_spec,
                                              list(params.values()))
        if type(self.optimizer) not in _ELEMENTWISE:
            raise ValueError(
                "member_layout='vmap' trains every member with one "
                "optimizer over the stacked weights, which equals one "
                "optimizer a member only for an element-wise rule (Adam, "
                "AdamW, SGD); got " + type(self.optimizer).__name__ +
                ": use member_layout='map'")
        self.num_steps = 0
        drops = [(n, m) for n, m in self.net.named_modules()
                 if isinstance(m, MaskedDropout) and m.p > 0]
        mask_shapes = None
        avg = SwaState(params) if swa else None
        gens = [run_gens[i] for i in order]
        step = vmap(lambda p, b, masks, x: functional_call(
            call, (p, b, masks), (x,)), randomness="error")
        losses = []
        for e in range(self.member_schedules.shape[1]):
            batches, masks = [], {"net." + n + ".mask": [] for n, _ in drops}
            for i, g in zip(order, gens):
                bi = int(self.member_schedules[i, e])
                batches.append(self._augmented(
                    self.Xb_train[bi], self.yb_train[bi], g))
                if drops and mask_shapes is None:
                    mask_shapes = _dropout_shapes(self, drops,
                                                  batches[-1][0])
                for (n, m), shape in zip(drops, mask_shapes or ()):
                    masks["net." + n + ".mask"].append(torch.rand(
                        shape, generator=g, device=self.device) >= m.p)
            X = torch.stack([b[0] for b in batches])
            y = torch.stack([b[1] for b in batches])
            masks = {k: torch.stack(v) for k, v in masks.items()}
            self.optimizer.zero_grad(set_to_none=True)
            with self.precision.tf32_scope(), autocast_in_vmap():
                out = step(params, buffers, masks, X)
                loss = torch.stack([self.criterion(out[j], y[j])
                                    for j in range(len(order))])
                loss.sum().backward()
            if self.lrs is not None:
                lr = self.lrs[min(self.num_steps, len(self.lrs) - 1)]
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
            self.optimizer.step()
            self.num_steps += 1
            losses.append(loss.detach())
            if avg is not None and e >= swa_start:
                avg.update(params)
        with torch.no_grad():
            if avg is not None:
                for k, p in avg.mean().items():
                    params[k].copy_(p)
            stacked = {k[len("net."):]: v.detach()
                       for k, v in {**params, **buffers}.items()}
            states = {i: {k: stacked[k][j].clone() for k in keys}
                      for j, i in enumerate(order)}
        losses = torch.stack(losses, 1)      # (members, cycles)
        return states, {i: losses[j] for j, i in enumerate(order)}

    def _gather_members(self, mesh, n_models: int, cycles: int,
                        states: Dict[int, State],
                        losses: Dict[int, torch.Tensor]) -> None:
        """Fills ``states`` and ``losses`` with every member, each
        broadcast over the world from the rank that owns its block (rank
        0 without a mesh, where every rank trained replicas of them
        all)."""
        per_rank = n_models // axis_size(mesh, MODEL_AXIS)
        skeleton = self.net.state_dict()
        for i in range(n_models):
            if i not in states:
                states[i] = {k: torch.empty_like(v)
                             for k, v in skeleton.items()}
                losses[i] = torch.empty(cycles, device=self.device)
            owner = 0 if mesh is None else \
                block_owner(mesh, MODEL_AXIS, i // per_rank)
            broadcast_tensors([*states[i].values(), losses[i]], owner)

    # -------------------------------------------------------- strategies
    def train_baseline(self, X_train, y_train, X_test=None, y_test=None,
                       seed: int = 1, augment_fn=None) -> nn.Module:
        """Trains one model from fresh weights drawn from ``seed``, with
        the compiled kwargs (`etrainer.py:398-428`), on the automatic data
        mesh unless the trainer was compiled with ``mesh=False``."""
        if self.net is None:
            raise AssertionError("You need to set a model first")
        self.keys = GeneratorSeq(seed)
        self._reset_training_history()
        self.optimizer = None
        init_weights_(self.net, self.keys.next())
        kd = dict(self.kdict)
        kd["mesh"] = False if self.member_mesh is False else None
        self.compile_trainer((X_train, y_train, X_test, y_test), **kd)
        self.augment_fn = augment_fn
        self.run()
        return self.net

    def train_ensemble_from_scratch(self, X_train, y_train, X_test=None,
                                    y_test=None, n_models: int = 10,
                                    augment_fn=None, **kwargs: Any):
        """``n_models`` members from distinct initial weights; returns
        (the net, holding the last member, {member: state_dict})."""
        self.update_training_parameters(kwargs)
        print("Training ensemble models (strategy = 'from_scratch')")
        self._prepare(X_train, y_train, X_test, y_test)
        states = self._train_members(
            n_models, self.kdict.get("training_cycles", 1000),
            augment_fn=augment_fn, seed_offset=0,
            swa=self.kdict.get("swa", False))
        self.ensemble_state_dict = dict(enumerate(states))
        self.net.load_state_dict(states[-1])
        self.save_ensemble_metadict()
        return self.net, self.ensemble_state_dict

    def train_ensemble_from_baseline(self, X_train, y_train, X_test=None,
                                     y_test=None, basemodel=None,
                                     n_models: int = 10,
                                     training_cycles_base: int = 1000,
                                     training_cycles_ensemble: int = 100,
                                     augment_fn=None, **kwargs: Any):
        """Trains a baseline (or takes ``basemodel``: an ``nn.Module``, a
        model with a ``net``, or a ``state_dict``, whose parameters start
        every member; the BatchNorm statistics are the trainer's net's, as
        the JAX package takes only ``params``), then fine-tunes
        ``n_models`` members from it. Returns (the net, holding the
        members' mean parameters, {member: state_dict})."""
        self.update_training_parameters(kwargs)
        if basemodel is None:
            self.kdict["training_cycles"] = training_cycles_base
            print("Training baseline model...")
            self.train_baseline(X_train, y_train, X_test, y_test, 1,
                                augment_fn)
            base = _clone(self.net.state_dict())
        else:
            self._prepare(X_train, y_train, X_test, y_test)
            base = _clone(self.net.state_dict())
            base.update(self._parameters_of(basemodel))
        print("\nTraining ensemble models (strategy = 'from_baseline')")
        self.kdict["training_cycles"] = training_cycles_ensemble
        states = self._train_members(
            n_models, training_cycles_ensemble, from_state=base,
            augment_fn=augment_fn, seed_offset=2,
            swa=self.kdict.get("swa", False))
        self.ensemble_state_dict = dict(enumerate(states))
        final = dict(states[-1])
        for k, _ in self.net.named_parameters():
            final[k] = sum(s[k] for s in states) / n_models
        self.net.load_state_dict(final)
        self.save_ensemble_metadict()
        return self.net, self.ensemble_state_dict

    def train_swag(self, X_train, y_train, X_test=None, y_test=None,
                   n_models: int = 10, augment_fn=None, **kwargs: Any):
        """Trains a baseline with SWA and draws ``n_models`` weight samples
        from its running moments (`etrainer.py:484-502`); every sample
        keeps the baseline's BatchNorm statistics."""
        self.update_training_parameters(kwargs)
        self.kdict["swa"] = True
        self.train_baseline(X_train, y_train, X_test, y_test, 1, augment_fn)
        mean, var = self.running_weights_stats
        samples = sample_weights(mean, var,
                                 self.keys.next(device=self.device),
                                 n_models)
        base = self.net.state_dict()
        self.ensemble_state_dict = {i: {**_clone(base), **s}
                                    for i, s in enumerate(samples)}
        self.save_ensemble_metadict()
        return self.net, self.ensemble_state_dict

    # ------------------------------------------------------------- misc
    def _parameters_of(self, basemodel) -> State:
        if isinstance(basemodel, nn.Module):
            src = dict(basemodel.named_parameters())
        elif isinstance(getattr(basemodel, "net", None), nn.Module):
            src = dict(basemodel.net.named_parameters())
        else:
            src = basemodel
        return {k: torch.as_tensor(src[k]).detach().to(self.device).clone()
                for k, _ in self.net.named_parameters()}

    def _prepare(self, X_train, y_train, X_test, y_test) -> None:
        """Stages the data, the loss and the optimizer spec for member
        training (no fit; no data mesh: members see whole batches)."""
        kd = dict(self.kdict)
        kd["training_cycles"] = 1
        kd["mesh"] = False
        self.compile_trainer((X_train, y_train, X_test, y_test), **kd)

    def update_training_parameters(self, kwargs: Dict[str, Any]) -> None:
        """Updates the compiled kwargs, warning on each overwritten one."""
        warn_msg = ("Overwriting the initial value '{}' of parameter "
                    "'{}' with new value '{}'")
        for k, v in kwargs.items():
            if k in self.kdict:
                warnings.warn(warn_msg.format(self.kdict[k], k, v),
                              UserWarning)
            self.kdict[k] = v

    def save_ensemble_metadict(self, filename: Optional[str] = None) -> str:
        """Writes ``<filename>_ensemble_metadict.aoit``: the metadict, the
        net's ``state_dict`` (``params``) and every member's
        (``ensemble``); :func:`load_ensemble` reads it."""
        fname = self.filename if filename is None else filename
        meta = {k: v for k, v in self.meta_state_dict.items()
                if k not in ("weights", "optimizer")}
        arrays = {"params": self.net.state_dict(),
                  "ensemble": {str(k): v for k, v in
                               self.ensemble_state_dict.items()}}
        return save_checkpoint(fname + "_ensemble_metadict", meta, arrays)


class EnsembleTrainer(BaseEnsembleTrainer):
    """Deep-ensemble trainer of segmentation nets ("Unet", "dilnet",
    "SegResNet", "ResHedNet", with ``init_fcnn_model``'s kwargs), ImSpec nets
    ("imspec", with ``in_dim``, ``out_dim`` and ``latent_dim``) or a custom
    ``nn.Module`` that takes the staged batches as they are.

    Example:
        >>> et = aoi.trainers.EnsembleTrainer("Unet", nb_classes=1,
        ...                                   device="cuda")
        >>> et.compile_ensemble_trainer(training_cycles=500)
        >>> net, ensemble = et.train_ensemble_from_scratch(
        ...     images, labels, images_test, labels_test, n_models=10)
    """

    def __init__(self, model: Union[str, nn.Module] = None,
                 nb_classes: int = 1, **kwargs: Any):
        super().__init__(**kwargs)
        self.nb_classes = nb_classes
        self.in_dim = self.out_dim = None
        if isinstance(model, str):
            if model in ("Unet", "dilnet", "SegResNet", "ResHedNet"):
                self.net, self.meta_state_dict = init_fcnn_model(
                    model, self.nb_classes, **kwargs)
                self._task = "seg"
            elif model == "imspec":
                missing = [k for k in ("in_dim", "out_dim", "latent_dim")
                           if k not in kwargs]
                if missing:
                    raise AssertionError(
                        "Specify input, output, and latent dimensions "
                        "(Missing dimensions: {})".format(
                            str(missing)[1:-1]))
                self.in_dim = tuple(kwargs.pop("in_dim"))
                self.out_dim = tuple(kwargs.pop("out_dim"))
                self.net, self.meta_state_dict = init_imspec_model(
                    self.in_dim, self.out_dim, kwargs.pop("latent_dim"),
                    **kwargs)
                self._task = "imspec"
            else:
                raise NotImplementedError(
                    "Pass one of 'Unet', 'dilnet', 'SegResNet', "
                    "'ResHedNet', 'imspec' or a custom module")
            init_weights_(self.net, generator_from_seed(self.seed))
        else:
            self.net = model
            self._task = "custom"
        self.net.to(self.device).eval()

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        """Segmentation: NHWC batch -> channel-last float32 logits (the
        nets are NCHW); other tasks: the net's output of the batch."""
        if self._task != "seg":
            return super().forward(X)
        with self.precision.scope(self.device):
            out = self.net(X.permute(0, 3, 1, 2))
        return out.float().permute(0, 2, 3, 1)

    def accuracy_fn(self, y: torch.Tensor, y_prob: torch.Tensor
                    ) -> torch.Tensor:
        if self._task == "seg":
            return iou_score(y, y_prob)
        raise NotImplementedError

    def set_data(self, X_train, y_train, X_test=None, y_test=None,
                 **kwargs) -> None:
        """Task-aware staging: segmentation images NHWC and masks with
        their class count checked; ImSpec pairs with a singleton channel
        squeezed; custom data as float32, as given."""
        if self._task == "seg":
            nb_classes = preproc.num_classes_from_labels(
                np.asarray(y_train))
            if nb_classes != self.nb_classes:
                raise AssertionError(
                    "Number of specified classes is different from the "
                    "number of classes contained in training data")
        if X_test is None or y_test is None:
            X_train, y_train, X_test, y_test = preproc.data_split(
                X_train, y_train, kwargs.get("test_size", .15),
                kwargs.get("seed", 1))
        if self._task == "seg":
            data = preproc.cast_image_arrays(*preproc.check_image_dims(
                X_train, y_train, X_test, y_test, nb_classes), nb_classes)
        else:
            if self._task == "imspec":
                X_train, y_train, X_test, y_test = \
                    preproc.check_signal_dims(X_train, y_train, X_test,
                                              y_test)
            data = [np.asarray(a, np.float32)
                    for a in (X_train, y_train, X_test, y_test)]
        self._stage_batches(*data)
