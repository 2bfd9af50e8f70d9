"""BatchNorm over the global batch of a data-parallel step.

Under a data mesh the JAX program's BatchNorm takes its statistics over the
whole batch, since XLA reduces across the shards; a BatchNorm over each
rank's rows would compute another function. ``torch.nn.SyncBatchNorm``
computes the right one but takes CUDA tensors only, so the port has its
own, one ``torch.autograd.Function`` for both devices:

- the forward all-gathers each rank's per-channel (mean, sum of squared
  deviations) and merges them (Chan et al.'s parallel variance, stable
  where the mean is large against the spread), normalises with the
  global mean and biased variance, and moves the running statistics with
  the global mean and torch's unbiased variance over the global count;
- the backward all-reduces the two per-channel sums the input's gradient
  needs (of the output's gradient, and of it times the normalised input)
  and returns the weight's and the bias's gradients of the rank's rows,
  which ``core.mesh.mean_gradients`` averages with the other gradients.

:func:`global_batch_norm` swaps it in for the BatchNorm layers of a net
(their ``forward``, on the instances) while a data-parallel step runs in
training mode; the modules, their names and their state stay those of
``nn.BatchNorm1d/2d``, so checkpoints and ``predict`` never see it.
"""

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn

from ..core.mesh import active_split


class GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation of ``x`` (N, C, ...) with the
    statistics of every rank's rows in the process group ``pg``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, pg):
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        n_local = x.numel() // x.shape[1]
        mean_r = xf.mean(dims)
        m2_r = ((xf - mean_r.view(shape)) ** 2).sum(dims)
        k = dist.get_world_size(pg)
        parts = [torch.empty_like(torch.stack([mean_r, m2_r]))
                 for _ in range(k)]
        dist.all_gather(parts, torch.stack([mean_r, m2_r]), group=pg)
        stats = torch.stack(parts)                       # (k, 2, C)
        n = n_local * k
        mean = stats[:, 0].mean(0)
        m2 = stats[:, 1].sum(0) + n_local * (
            (stats[:, 0] - mean) ** 2).sum(0)
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        if running_mean is not None:
            running_mean.mul_(1 - momentum).add_(
                mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1 - momentum).add_(
                (m2 / max(n - 1, 1)).to(running_var.dtype), alpha=momentum)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.pg, ctx.dims, ctx.shape = n, pg, dims, shape
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        xhat, invstd, weight = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        gyf = gy.float()
        sum_gy = gyf.sum(dims)
        sum_gy_xhat = (gyf * xhat).sum(dims)
        both = torch.stack([sum_gy, sum_gy_xhat])
        dist.all_reduce(both, group=ctx.pg)
        scale = invstd if weight is None else invstd * weight.float()
        gx = scale.view(shape) * (
            gyf - (both[0] / ctx.n).view(shape)
            - xhat * (both[1] / ctx.n).view(shape))
        gw = gb = None
        if weight is not None:
            gw, gb = sum_gy_xhat.to(weight.dtype), sum_gy.to(weight.dtype)
        return gx.to(gy.dtype), gw, gb, None, None, None, None, None


def _forward(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor
             ) -> torch.Tensor:
    split = active_split()
    if not bn.training or split is None:
        return type(bn).forward(bn, x)
    momentum = 0.0
    if bn.track_running_stats:
        bn.num_batches_tracked.add_(1)
        momentum = 1.0 / float(bn.num_batches_tracked) \
            if bn.momentum is None else bn.momentum
    return GlobalBatchNorm.apply(
        x, bn.weight, bn.bias,
        bn.running_mean if bn.track_running_stats else None,
        bn.running_var if bn.track_running_stats else None,
        bn.eps, momentum, split.pg)


@contextlib.contextmanager
def global_batch_norm(net: nn.Module):
    """Within the block, ``net``'s BatchNorm layers in training mode take
    the global batch's statistics wherever ``core.mesh.split_batch`` is
    active (and are torch's own elsewhere); put back on exit. Hold it over
    the backward too: a rematerialised block runs its forward again
    there. Nothing is swapped outside a split step."""
    if active_split() is None:
        yield
        return
    bns = [m for m in net.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.forward = _forward.__get__(m)
    try:
        yield
    finally:
        for m in bns:
            del m.forward
