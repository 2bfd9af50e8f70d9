"""Building blocks of the segmentation, im2spec, denoising and
regression/classification nets (NCHW / NCL).

Counterpart of `atomai_tpu/nets/blocks.py:104-327`:
- ConvBlock: [conv -> (dropout) -> LeakyReLU(0.01) -> (BatchNorm)] x n, 1D
  or 2D,
- UpsampleBlock: 2x interpolation (bilinear / nearest; 1D nearest) + 1x1
  conv,
- ResBlock / ResModule: 1x1 in-projection (the residual), two 3x3 convs
  each with BatchNorm, the skip add, LeakyReLU; a stack of them,
- DilatedBlock: a cascade of dilated convs whose forward returns the sum of
  every sub-layer's output,
- ConvBackbone: a feature extractor + global average pool -> (batch,
  features): the torchvision topologies of ``backbones.py`` or the
  ``*-slim`` strided conv stacks,
- max_pool: 2x2 window, stride 2;
- Dropout: ``nn.Dropout`` that draws its mask from an explicit generator.

Submodules carry the names of original atomai's modules (``block.<i>``,
``conv``), so ``state_dict`` keys line up with its checkpoints. torch's
default init of ``nn.Conv2d`` and ``nn.Linear`` is the distribution the JAX
package imitates (`atomai_tpu/nets/blocks.py:72-101` ``init_kwargs``):
``kaiming_uniform(a=sqrt(5))`` weights, i.e. U(+-sqrt(1/fan_in)), and
U(+-1/sqrt(fan_in)) biases. :func:`init_weights_` redraws both from an
explicit generator; a module with an ``init_weights_`` method of its own
(the torchvision backbones) draws itself.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.mesh import draw_rows
from .backbones import BACKBONE_FEATURES
from .remat import Rematerializable


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from ``self.generator`` when one
    is set (the trainers set it for each step, so no draw touches torch's
    global generator); without one it is ``nn.Dropout``. In a step split
    over a data mesh the mask is the global batch's, sliced to the rank's
    rows (``core.mesh.draw_rows``)."""

    generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0 or self.generator is None:
            return super().forward(x)
        keep = draw_rows(torch.rand, x.shape, generator=self.generator,
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


class ConvBlock(Rematerializable, nn.Module):
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


class DilatedBlock(Rematerializable, nn.Module):
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


class UpsampleBlock(Rematerializable, nn.Module):
    """Interpolation upsampling (bilinear / nearest) followed by a 1x1 conv,
    2D (NCHW) or 1D (NCL, always nearest, as the JAX block forces it).

    ``jax.image.resize(..., "linear")`` at an integer upscale samples at
    half-pixel centres with clamped edges, as ``align_corners=False`` does;
    its "nearest" at an integer upscale repeats each sample, as torch's.
    """

    def __init__(self, ndim: int, input_channels: int, output_channels: int,
                 scale_factor: int = 2, mode: str = "bilinear"):
        super().__init__()
        if mode not in ("bilinear", "nearest"):
            raise NotImplementedError(
                "use 'bilinear' or 'nearest' for upsampling mode")
        if ndim not in _CONV:
            raise AssertionError("ndim must be 1 or 2")
        self.scale_factor = scale_factor
        self.mode = mode if ndim == 2 else "nearest"
        self.conv = _CONV[ndim](input_channels, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=self.scale_factor, mode=self.mode,
                          align_corners=False if self.mode == "bilinear"
                          else None)
        return self.conv(x)


class ResBlock(nn.Module):
    """1x1 in-projection (also the residual), then [3x3 conv -> (BatchNorm)
    -> LeakyReLU] and [3x3 conv -> (BatchNorm)], the skip add, LeakyReLU
    (`atomai_tpu/nets/blocks.py:164-199`); 1D or 2D. ``kernel_size``,
    ``stride`` and ``padding`` are accepted and unused, as in the JAX
    package and original atomai: the convs are always 1x1 and 3x3/1."""

    def __init__(self, ndim: int, input_channels: int, output_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 batch_norm: bool = True, lrelu_a: float = 0.01):
        super().__init__()
        if ndim not in _CONV:
            raise AssertionError("ndim must be 1 or 2")
        conv, c = _CONV[ndim], output_channels
        self.lrelu_a = lrelu_a
        self.c0 = conv(input_channels, c, 1)
        self.c1 = conv(c, c, 3, padding=1)
        self.bn1 = _BATCH_NORM[ndim](c) if batch_norm else nn.Identity()
        self.c2 = conv(c, c, 3, padding=1)
        self.bn2 = _BATCH_NORM[ndim](c) if batch_norm else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.c0(x)
        out = F.leaky_relu(self.bn1(self.c1(x)), self.lrelu_a)
        out = self.bn2(self.c2(out))
        return F.leaky_relu(out + x, self.lrelu_a)


class ResModule(Rematerializable, nn.Module):
    """A stack of ``res_depth`` residual blocks
    (`atomai_tpu/nets/blocks.py:202-216`)."""

    def __init__(self, ndim: int, res_depth: int, input_channels: int,
                 output_channels: int, batch_norm: bool = True,
                 lrelu_a: float = 0.01):
        super().__init__()
        self.c0 = nn.Sequential(*[
            ResBlock(ndim, input_channels if i == 0 else output_channels,
                     output_channels, batch_norm=batch_norm,
                     lrelu_a=lrelu_a)
            for i in range(res_depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c0(x)


class ConvBackbone(nn.Module):
    """A backbone + global average pool -> (batch, ``in_features``)
    (`atomai_tpu/nets/blocks.py:267-322`).

    "resnet", "vgg" and "mobilenet" are the torchvision topologies of
    ``backbones.py`` (``self.features``), in float32 outside autocast, as
    the JAX modules carry no compute dtype. The ``*-slim`` presets are a
    3x3/2 stem conv (BatchNorm, LeakyReLU) then one 3x3/2 conv, BatchNorm
    and LeakyReLU per width (``convs``, ``bns``). Precision as in the JAX
    package: the convs and the stem's BatchNorm in the compute dtype, the
    loop's BatchNorms (no ``dtype`` there) in float32.
    """

    PRESETS = {
        "mobilenet-slim": (32, (64, 128, 256, 1280)),
        "resnet-slim": (64, (256, 512, 1024, 2048)),
        "vgg-slim": (64, (128, 256, 512, 512)),
    }

    def __init__(self, backbone_type: str = "mobilenet",
                 input_channels: int = 1):
        super().__init__()
        self.backbone_type = backbone_type
        self.features = None
        if backbone_type in BACKBONE_FEATURES:
            self.features = BACKBONE_FEATURES[backbone_type](input_channels)
            self.in_features = self.features.in_features
            return
        if backbone_type not in self.PRESETS:
            raise ValueError(
                "Unsupported backbone_type. Choose 'resnet', 'vgg', "
                "'mobilenet' or a '*-slim' variant.")
        stem, widths = self.PRESETS[backbone_type]
        chans = [input_channels, stem, *widths]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, 2, 1)
                                   for a, b in zip(chans, chans[1:]))
        self.bns = nn.ModuleList(nn.BatchNorm2d(c) for c in chans[1:])
        self.in_features = widths[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.features is not None:
            with torch.autocast(x.device.type, enabled=False):
                return self.features(x.float()).mean((2, 3))
        x = F.leaky_relu(self.bns[0](self.convs[0](x)), 0.01)
        for conv, bn in zip(self.convs[1:], self.bns[1:]):
            x = F.leaky_relu(bn(conv(x).float()), 0.01)
        return x.mean((2, 3))


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
    draws its weight only. A module with its own ``init_weights_`` method
    (the torchvision backbones) draws itself, in the same order."""
    m = module
    if callable(getattr(m, "init_weights_", None)):
        m.init_weights_(generator)
        return
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
    for child in m.children():
        init_weights_(child, generator)
