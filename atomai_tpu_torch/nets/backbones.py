"""ResNet50 / VGG16 / MobileNetV2 feature extractors (NCHW).

Counterpart of `atomai_tpu/nets/backbones.py:33-187`: torchvision's
``resnet50`` without avgpool and fc, ``vgg16.features`` without its last
max pool, and ``mobilenet_v2.features``, each with an
``input_channels``-channel first convolution, built here without
torchvision. Submodules carry torchvision's names, so the ``state_dict`` of
a torchvision model (``resnet50()`` without ``fc.*``, ``vgg16().features``,
``mobilenet_v2().features``) loads into them key for key.

Convolutions are drawn as torchvision draws them (the JAX package's
``_TV_CONV_INIT``, `atomai_tpu/nets/backbones.py:28-31`): kaiming normal
with fan_out, N(0, 2 / fan_out), biases 0, BatchNorm at identity;
:meth:`init_weights_` redraws them from a generator. The JAX modules have
no compute dtype, so they run in float32 under the mixed policy (the caller
turns autocast off, :class:`~atomai_tpu_torch.nets.blocks.ConvBackbone`).
"""

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn


class _TorchvisionInit:
    """torchvision's init of the backbones, drawn from a generator."""

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * math.prod(m.kernel_size)
                m.weight.copy_(torch.empty(
                    m.weight.shape, device=generator.device).normal_(
                        0.0, math.sqrt(2.0 / fan_out), generator=generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """torchvision's ResNet Bottleneck (expansion 4, stride on the 3x3)."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = _bn(filters)
        self.conv3 = nn.Conv2d(filters, 4 * filters, 1, bias=False)
        self.bn3 = _bn(4 * filters)
        self.relu = nn.ReLU()
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, 4 * filters, 1, stride, bias=False),
            _bn(4 * filters)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class ResNet50Features(_TorchvisionInit, nn.Module):
    """conv 7x7/2 -> bn -> relu -> maxpool 3/2 -> 4 bottleneck stages
    [3, 4, 6, 3]: 2048 channels at 1/32 resolution."""
    in_features = 2048

    def __init__(self, input_channels: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(input_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)   # pads with -inf, as flax
        in_ch = 64
        for li, (f, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)], 1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(in_ch, f, stride if b == 0 else 1,
                                        downsample=b == 0))
                in_ch = 4 * f
            setattr(self, f"layer{li}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)


class VGG16Features(_TorchvisionInit, nn.Sequential):
    """torchvision's ``vgg16.features`` without the last max pool: 13
    conv 3x3 + ReLU with 4 max pools inside; 512 channels at 1/16."""
    in_features = 512

    def __init__(self, input_channels: int = 1):
        layers, cin = [], input_channels
        for v in _VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        super().__init__(*layers)


def _conv_bn_relu6(cin: int, cout: int, k: int, stride: int = 1,
                   groups: int = 1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                  bias=False), _bn(cout), nn.ReLU6())


class InvertedResidual(nn.Module):
    """torchvision's MobileNetV2 inverted residual: (1x1 expansion) ->
    depthwise 3x3 -> 1x1 projection, with the skip when the shape stays."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 expand_ratio: int):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.use_res_connect = stride == 1 and in_ch == out_ch
        layers = [] if expand_ratio == 1 else [
            _conv_bn_relu6(in_ch, hidden, 1)]
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, out_ch, 1, bias=False), _bn(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x) if self.use_res_connect else self.conv(x)


_MBV2_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2Features(_TorchvisionInit, nn.Sequential):
    """torchvision's ``mobilenet_v2.features``: conv 3x3/2 (32) -> 17
    inverted residuals -> conv 1x1 (1280); 1280 channels at 1/32."""
    in_features = 1280

    def __init__(self, input_channels: int = 1):
        layers, in_ch = [_conv_bn_relu6(input_channels, 32, 3, 2)], 32
        for t, c, n, s in _MBV2_CFG:
            for i in range(n):
                layers.append(InvertedResidual(in_ch, c, s if i == 0 else 1,
                                               t))
                in_ch = c
        layers.append(_conv_bn_relu6(in_ch, 1280, 1))
        super().__init__(*layers)


BACKBONE_FEATURES = {
    "resnet": ResNet50Features,
    "vgg": VGG16Features,
    "mobilenet": MobileNetV2Features,
}
