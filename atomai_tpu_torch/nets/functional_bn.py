"""BatchNorm, Dropout and autocast that ``torch.func.vmap`` can batch.

The members of an ensemble run as one ``torch.func.vmap`` of
``functional_call`` over their stacked weights and buffers: the ensemble
predictor's "vmap" layout (eval mode) and the ensemble trainer's (train
mode). ``torch.batch_norm`` on CUDA asks its input for its memory format,
which a tensor batched by vmap cannot answer, so :class:`VmapBatchNorm`
computes BatchNorm from elementwise ops and reductions, under
BatchNorm's parameter and buffer names (so ``state_dict`` keys, and the
stacked leaves, are the original layer's).

Train mode computes what ``nn.BatchNorm1d/2d`` computes: the batch mean
and the biased batch variance (centred, two passes) normalise the input;
the running mean and the unbiased running variance move by ``momentum``
and ``num_batches_tracked`` counts the step. Statistics and the
normalisation run in float32 and the output takes the input's dtype (so
bf16 under autocast, as cuDNN's). The JAX counterpart is flax's
``BatchNorm`` under ``mutable=["batch_stats"]`` in the vmapped member step
(`atomai_tpu/trainers/etrainer.py:291-301`).

The running statistics are updated in place. Under vmap the buffers enter
with ``in_dims=0`` from the members' stacked buffers, so each in-place
update writes every member's slice of the stacked tensor, and the step
needs no second output: ``functional_call`` hands the net's forward its
usual return value. (Returning the statistics as outputs, the other way,
would need every net's forward to carry them out.) The update runs under
``no_grad`` on a batched tensor, which vmap allows on the CPU and on the
card; a ``torch.func.grad`` around it would not, so the ensemble trainer
takes its gradients with autograd on the stacked leaves, outside the
vmap.

:class:`MaskedDropout` takes its keep-mask as a buffer: a random draw
inside the vmap would give every member one mask (or raise, under
``randomness="error"``), so the trainer draws each member's masks outside
it, from the member's own generator in the order of the loop's draws, and
hands them in stacked.

:func:`autocast_in_vmap`: ``torch.autocast`` does not reach the ops of a
vmapped function (a conv inside ``torch.func.vmap`` under bf16 autocast
runs, and returns, float32; a bilinear upsampling, which CUDA autocast
runs in float32, runs in bf16, its backward accumulating in bf16). The
context applies autocast's casts to the ops the port's nets call, where
autocast is enabled for the arguments' device: those autocast runs in
its lower precision (convolutions, linear layers, matrix products) get
their floating-point arguments in the autocast dtype, and on CUDA those
it runs in float32 (interpolation, softmax, softplus, exp, log, pow,
sums, norms) get theirs in float32. Every other op runs as without it,
as under autocast, and a region with autocast disabled (the float32
heads) runs as it is.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

# the ops that autocast runs in its lower precision, on the CPU and on
# CUDA (torch.amp's "Ops that can autocast to float16 / bfloat16")
_LOWER = {torch.conv1d, torch.conv2d, torch.conv3d, torch.conv_transpose1d,
          torch.conv_transpose2d, torch.conv_transpose3d, F.linear,
          torch.matmul, torch.mm, torch.bmm, torch.baddbmm, torch.addmm,
          torch.addbmm, torch.mv, torch.Tensor.matmul,
          torch.Tensor.__matmul__, torch.Tensor.mm, torch.Tensor.bmm}
# the ops that CUDA autocast runs in float32 ("CUDA Ops that can autocast
# to float32"; the upsampling ops are on that list, not on the CPU's)
_FLOAT32 = {"cuda": {
    F.interpolate, torch.softmax, F.softmax, torch.log_softmax,
    F.log_softmax, F.softplus, torch.exp, torch.log, torch.log1p,
    torch.rsqrt, torch.pow, torch.sum, torch.cumsum, torch.prod,
    F.layer_norm, F.group_norm, torch.Tensor.exp, torch.Tensor.log,
    torch.Tensor.log1p, torch.Tensor.rsqrt, torch.Tensor.pow,
    torch.Tensor.__pow__, torch.Tensor.sum, torch.Tensor.softmax,
    torch.Tensor.log_softmax}}


class VmapBatchNorm(nn.Module):
    """A BatchNorm layer as elementwise ops, sharing the parameters and
    buffers of ``bn`` (an ``nn.BatchNorm1d/2d``); its ``training`` flag as
    ``bn``'s. Eval mode is ``x * scale + shift`` from the running
    statistics, in float32."""

    def __init__(self, bn: nn.modules.batchnorm._BatchNorm):
        super().__init__()
        if bn.momentum is None or bn.running_mean is None:
            raise ValueError("VmapBatchNorm needs a BatchNorm with running "
                             "statistics and a momentum")
        self.eps, self.momentum = bn.eps, bn.momentum
        self.weight, self.bias = bn.weight, bn.bias
        for name in ("running_mean", "running_var", "num_batches_tracked"):
            self.register_buffer(name, getattr(bn, name))
        self.train(bn.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.reshape(shape) + shift.reshape(shape)
        dims = [0, *range(2, x.ndim)]
        xf = x.float()
        mean = xf.mean(dims)
        centred = xf - mean.reshape(shape)
        var = centred.square().mean(dims)
        with torch.no_grad():
            n = xf.numel() // xf.shape[1]
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        y = centred * torch.rsqrt(var + self.eps).reshape(shape)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class MaskedDropout(nn.Module):
    """Dropout with a given keep-mask: in train mode ``x * mask / (1 - p)``
    (the port's ``Dropout`` formula) where ``mask`` (a bool buffer of the
    input's shape, not in the ``state_dict``) is set by the caller, for
    instance through ``functional_call``; identity in eval mode."""

    def __init__(self, drop: nn.Dropout):
        super().__init__()
        self.p = drop.p
        self.register_buffer("mask", None, persistent=False)
        self.train(drop.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        if self.mask is None:
            raise RuntimeError("MaskedDropout draws nothing: give it the "
                               "keep-mask of this call")
        return x * self.mask.to(x.dtype) / (1.0 - self.p)


def vmappable(net: nn.Module) -> nn.Module:
    """``net`` with every ``nn.BatchNorm1d/2d`` replaced, in place, by a
    :class:`VmapBatchNorm` that shares its tensors, and every
    ``nn.Dropout`` (the port's generator-driven one included) by a
    :class:`MaskedDropout`; returns ``net``."""
    for name, child in net.named_children():
        if isinstance(child, nn.modules.batchnorm._BatchNorm):
            setattr(net, name, VmapBatchNorm(child))
        elif isinstance(child, nn.Dropout):
            setattr(net, name, MaskedDropout(child))
        else:
            vmappable(child)
    return net


class _Autocast(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], torch.Tensor):
            kind = args[0].device.type
            dtype = None
            if torch.is_autocast_enabled(kind):
                if func in _LOWER:
                    dtype = torch.get_autocast_dtype(kind)
                elif func in _FLOAT32.get(kind, ()):
                    dtype = torch.float32
            if dtype is not None:
                args, kwargs = tree_map(lambda t: t.to(dtype) if isinstance(
                    t, torch.Tensor) and t.is_floating_point() else t,
                    (args, kwargs))
        return func(*args, **kwargs)


def autocast_in_vmap() -> TorchFunctionMode:
    """A context manager: autocast's casts for the ops run in the
    enclosed code, vmapped or not (see the module's docstring)."""
    return _Autocast()
