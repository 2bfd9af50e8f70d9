"""Building blocks of the segmentation nets (NCHW).

Counterpart of `atomai_tpu/nets/blocks.py:104-161, 323-327`:
- ConvBlock: [conv -> (dropout) -> LeakyReLU(0.01) -> (BatchNorm)] x n,
- UpsampleBlock: 2x interpolation (bilinear / nearest) + 1x1 conv,
- max_pool: 2x2 window, stride 2.

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


class ConvBlock(nn.Module):
    """Block of [conv -> (dropout) -> LeakyReLU -> (batchnorm)] x nb_layers.

    Only 2D is ported; BatchNorm keeps flax's epsilon (1e-5), and torch's
    momentum 0.1 is flax's 0.9.
    """

    def __init__(self, ndim: int, nb_layers: int, input_channels: int,
                 output_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, batch_norm: bool = False,
                 lrelu_a: float = 0.01, dropout_: float = 0.0):
        super().__init__()
        if ndim != 2:
            raise NotImplementedError("only 2D ConvBlocks are ported")
        block = []
        for idx in range(nb_layers):
            cin = output_channels if idx > 0 else input_channels
            block.append(nn.Conv2d(cin, output_channels, kernel_size,
                                   stride=stride, padding=padding))
            if dropout_ > 0:
                block.append(nn.Dropout(dropout_))
            block.append(nn.LeakyReLU(negative_slope=lrelu_a))
            if batch_norm:
                block.append(nn.BatchNorm2d(output_channels, eps=1e-5,
                                            momentum=0.1))
        self.block = nn.Sequential(*block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


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


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraws every conv's and linear layer's weight and bias from
    U(+-1/sqrt(fan_in)) with ``generator`` (torch's default init, drawn
    reproducibly) and resets BatchNorm to identity statistics. A linear
    layer without bias (the rVAE's ``fc_latent``) draws its weight only."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            else:
                fan_in = m.in_features
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
