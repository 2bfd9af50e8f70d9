"""Building blocks of the segmentation and im2spec nets (NCHW / NCL).

Counterpart of `atomai_tpu/nets/blocks.py:104-161, 219-264, 323-327`:
- ConvBlock: [conv -> (dropout) -> LeakyReLU(0.01) -> (BatchNorm)] x n, 1D
  or 2D,
- DilatedBlock: a cascade of dilated convs whose forward returns the sum of
  every sub-layer's output,
- UpsampleBlock: 2x interpolation (bilinear / nearest) + 1x1 conv,
- max_pool: 2x2 window, stride 2;
- Dropout: ``nn.Dropout`` that draws its mask from an explicit generator.

Submodules carry the names of original atomai's modules (``block.<i>``,
``conv``), so ``state_dict`` keys line up with its checkpoints. torch's
default init of ``nn.Conv2d`` and ``nn.Linear`` is the distribution the JAX
package imitates (`atomai_tpu/nets/blocks.py:72-101` ``init_kwargs``):
``kaiming_uniform(a=sqrt(5))`` weights, i.e. U(+-sqrt(1/fan_in)), and
U(+-1/sqrt(fan_in)) biases. :func:`init_weights_` redraws both from an
explicit generator.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from ``self.generator`` when one
    is set (the trainers set it for each step, so no draw touches torch's
    global generator); without one it is ``nn.Dropout``."""

    generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0 or self.generator is None:
            return super().forward(x)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


_CONV = {1: nn.Conv1d, 2: nn.Conv2d}
_BATCH_NORM = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d}


def _conv_layers(ndim: int, cin: int, cout: int, kernel_size: int,
                 stride: int, padding: int, dilation: int, batch_norm: bool,
                 lrelu_a: float, dropout_: float) -> list:
    """[conv, (dropout), LeakyReLU, (BatchNorm)]: one layer of a block.
    BatchNorm keeps flax's epsilon (1e-5), and torch's momentum 0.1 is
    flax's 0.9."""
    if ndim not in _CONV:
        raise AssertionError("ndim must be 1 or 2")
    layers = [_CONV[ndim](cin, cout, kernel_size, stride=stride,
                          padding=padding, dilation=dilation)]
    if dropout_ > 0:
        layers.append(Dropout(dropout_))
    layers.append(nn.LeakyReLU(negative_slope=lrelu_a))
    if batch_norm:
        layers.append(_BATCH_NORM[ndim](cout, eps=1e-5, momentum=0.1))
    return layers


class ConvBlock(nn.Module):
    """Block of [conv -> (dropout) -> LeakyReLU -> (batchnorm)] x nb_layers,
    1D (NCL) or 2D (NCHW)."""

    def __init__(self, ndim: int, nb_layers: int, input_channels: int,
                 output_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, batch_norm: bool = False,
                 lrelu_a: float = 0.01, dropout_: float = 0.0):
        super().__init__()
        block = []
        for idx in range(nb_layers):
            cin = output_channels if idx > 0 else input_channels
            block += _conv_layers(ndim, cin, output_channels, kernel_size,
                                  stride, padding, 1, batch_norm, lrelu_a,
                                  dropout_)
        self.block = nn.Sequential(*block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DilatedBlock(nn.Module):
    """Cascade of dilated (atrous) convolutions, 1D or 2D.

    Parity quirk (`atomai_tpu/nets/blocks.py:219-264`, after original
    atomai): the forward returns the *sum* of every sub-layer's output in
    the cascade: each conv, each dropout, each activation and each
    BatchNorm. Layer i has dilation and padding ``dilation_values[i]``,
    ``padding_values[i]``.
    """

    def __init__(self, ndim: int, input_channels: int, output_channels: int,
                 dilation_values, padding_values, kernel_size: int = 3,
                 stride: int = 1, lrelu_a: float = 0.01,
                 batch_norm: bool = False, dropout_: float = 0.0):
        super().__init__()
        block = []
        for idx, (dil, pad) in enumerate(zip(dilation_values,
                                             padding_values)):
            cin = output_channels if idx > 0 else input_channels
            block += _conv_layers(ndim, cin, output_channels, kernel_size,
                                  stride, pad, dil, batch_norm, lrelu_a,
                                  dropout_)
        self.atrous_module = nn.ModuleList(block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for layer in self.atrous_module:
            x = layer(x)
            acc = x if acc is None else acc + x
        return acc


class UpsampleBlock(nn.Module):
    """Interpolation upsampling (bilinear / nearest) followed by a 1x1 conv.

    ``jax.image.resize(..., "linear")`` at an integer upscale samples at
    half-pixel centres with clamped edges, as ``align_corners=False`` does.
    """

    def __init__(self, ndim: int, input_channels: int, output_channels: int,
                 scale_factor: int = 2, mode: str = "bilinear"):
        super().__init__()
        if mode not in ("bilinear", "nearest"):
            raise NotImplementedError(
                "use 'bilinear' or 'nearest' for upsampling mode")
        if ndim != 2:
            raise NotImplementedError("only 2D UpsampleBlocks are ported")
        self.scale_factor = scale_factor
        self.mode = mode
        self.conv = nn.Conv2d(input_channels, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=self.scale_factor, mode=self.mode,
                          align_corners=False if self.mode == "bilinear"
                          else None)
        return self.conv(x)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """Max pooling over the spatial dims (VALID, as flax's ``max_pool``)."""
    return F.max_pool2d(x, window, stride)


def _uniform_(t: torch.Tensor, bound: float,
              generator: torch.Generator) -> None:
    """``t`` <- U(+-bound), drawn on the generator's device (so a module
    on the card takes the same draws from a host generator)."""
    t.copy_(torch.empty(t.shape, dtype=t.dtype, device=generator.device)
            .uniform_(-bound, bound, generator=generator))


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraws every conv's and linear layer's weight and bias from
    U(+-1/sqrt(fan_in)) with ``generator`` (torch's default init, drawn
    reproducibly, on any device) and resets BatchNorm to identity
    statistics. A linear layer without bias (the rVAE's ``fc_latent``)
    draws its weight only."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
            else:
                fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
