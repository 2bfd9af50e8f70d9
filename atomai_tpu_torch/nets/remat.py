"""Rematerialisation: blocks whose activations are recomputed in the
backward pass instead of kept (``fit(remat=True)``).

The JAX package wraps the whole training forward in ``jax.checkpoint``
(`atomai_tpu/trainers/trainer.py:353-354`, `vitrainer.py:269-271`). In
torch a whole-forward checkpoint saves nothing at the peak (the backward
rebuilds every activation at once), so the port checkpoints block by
block: each unit's forward runs under ``torch.utils.checkpoint``
(non-reentrant), which keeps only the unit's inputs and recomputes the
rest when the backward reaches it. The units are the classes with the
:class:`Rematerializable` mixin: the segmentation nets' ``ConvBlock``,
``DilatedBlock``, ``ResModule`` and ``UpsampleBlock`` (so the Unet's
``c1`` ... ``c6``, its bottleneck and its upsample blocks), the
torchvision backbones' ``Bottleneck`` and ``InvertedResidual``, and the
VAE encoders and decoders. A net with none of them (a user's module, a
VGG backbone) is one unit as a whole, the JAX package's contract.

A recompute must give the forward's numbers, and leave no trace:
- BatchNorm in train mode updates its running statistics on every call;
  the unit's buffers are put back after the recompute, so they move once
  a step, as without remat;
- a generator-driven :class:`Dropout` draws from ``self.generator``,
  which ``torch.utils.checkpoint`` does not restore (it restores torch's
  global generators only): the recompute runs from each generator's state
  at the forward, and the generator is then put back where it was, so the
  mask is the forward's and later draws are unmoved;
- the TF32 switches of the forward (autocast is replayed by
  ``torch.utils.checkpoint`` itself) hold in the recompute too.
So a remat fit is bit-identical to a plain fit wherever the recomputed
kernels are deterministic (always on the CPU).

:class:`~atomai_tpu_torch.nets.ed.rDecoderNet` decides for itself: its
fused route's ``spatial_mlp`` is never checkpointed on the card, since the
CUDA kernel pair keeps only its inputs and its backward kernel recomputes
the activations on chip already (a checkpoint would launch the forward
kernel twice a step and save nothing); on the CPU its plain version is
checkpointed.
"""

from typing import Callable, Dict

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint


def checkpointed(unit: nn.Module, fn: Callable, *args):
    """``fn(*args)`` (the forward of ``unit``) under a non-reentrant
    ``torch.utils.checkpoint`` whose recompute restores ``unit``'s buffers
    afterwards, replays the generators of its modules (a ``generator``
    attribute, as :class:`~atomai_tpu_torch.nets.blocks.Dropout` has) from
    their states at the forward, and runs under the forward's TF32
    switches."""
    gens = {id(g): g for g in (getattr(m, "generator", None)
                               for m in unit.modules())
            if isinstance(g, torch.Generator)}
    drawn_from = [(g, g.get_state()) for g in gens.values()]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        buffers = [b.clone() for b in unit.buffers()]
        now = [(g, g.get_state()) for g, _ in drawn_from]
        saved_tf32 = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        for g, state in drawn_from:
            g.set_state(state)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        try:
            return fn(*a)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved_tf32
            for g, state in now:
                g.set_state(state)
            with torch.no_grad():
                for b, saved in zip(unit.buffers(), buffers):
                    b.copy_(saved)

    return checkpoint(run, *args, use_reentrant=False)


class Rematerializable:
    """Mixin of a unit: with ``remat`` set, a training call with autograd
    on runs through :func:`checkpointed`."""

    remat = False

    def __call__(self, *args, **kwargs):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpointed(self, lambda *a: super(
                Rematerializable, self).__call__(*a, **kwargs), *args)
        return super().__call__(*args, **kwargs)


_WHOLE: Dict[type, type] = {}


def set_remat(net: nn.Module, on: bool = True) -> nn.Module:
    """Sets ``remat`` on every outermost unit of ``net`` (a unit inside a
    unit is left alone: one checkpoint covers it). A net that holds no
    unit becomes one: its class is swapped for a subclass of itself with
    the :class:`Rematerializable` mixin (same name, same ``state_dict``).
    Returns ``net``."""
    found = []

    def visit(m):
        if hasattr(type(m), "remat"):
            m.remat = on
            found.append(m)
            return
        for child in m.children():
            visit(child)
    visit(net)
    if not found and on:
        cls = type(net)
        if cls not in _WHOLE:
            _WHOLE[cls] = type(cls.__name__, (Rematerializable, cls),
                               {"__qualname__": cls.__qualname__,
                                "__module__": cls.__module__})
        net.__class__ = _WHOLE[cls]
        net.remat = True
    return net
