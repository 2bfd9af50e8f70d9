"""Regression and classification nets (NCHW).

Counterpart of `atomai_tpu/nets/reg_cls.py:17-97`: a
:class:`~atomai_tpu_torch.nets.blocks.ConvBackbone` (``backbone``) and a
linear head (``output_layer``), with a log-softmax for classification and
one head per task for multitask classification. The heads carry no
``dtype`` in the JAX package: here they run in float32 outside autocast.
"""

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.dtypes import head_f32
from .blocks import ConvBackbone


class RegressorNet(nn.Module):
    """Backbone + linear head -> (batch, output_size)."""

    def __init__(self, input_channels: int, output_size: int,
                 backbone_type: str = "mobilenet"):
        super().__init__()
        self.backbone = ConvBackbone(backbone_type, input_channels)
        self.output_layer = nn.Linear(self.backbone.in_features, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_f32(self.output_layer, self.backbone(x))


class ClassifierNet(nn.Module):
    """Backbone + linear head + log-softmax -> (batch, num_classes)."""

    def __init__(self, input_channels: int, num_classes: int,
                 backbone_type: str = "resnet"):
        super().__init__()
        self.backbone = ConvBackbone(backbone_type, input_channels)
        self.output_layer = nn.Sequential(
            nn.Linear(self.backbone.in_features, num_classes),
            nn.LogSoftmax(dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_f32(self.output_layer, self.backbone(x))


class MultiTaskClassifierNet(nn.Module):
    """A shared backbone with one linear + log-softmax head per task ->
    a list of (batch, num_classes[t])."""

    def __init__(self, input_channels: int, num_classes: Sequence[int],
                 backbone_type: str = "resnet"):
        super().__init__()
        self.backbone = ConvBackbone(backbone_type, input_channels)
        self.output_layers = nn.ModuleList(
            nn.Sequential(nn.Linear(self.backbone.in_features, n),
                          nn.LogSoftmax(dim=1)) for n in num_classes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone(x)
        return [head_f32(head, feats) for head in self.output_layers]


def init_reg_model(out_dim: int, backbone_type: str,
                   input_channels: int = 1, **kwargs: Any
                   ) -> Tuple[nn.Module, Dict[str, Any]]:
    """A regression net + its metadict."""
    return RegressorNet(input_channels, out_dim, backbone_type), {
        "model_type": "reg", "backbone": backbone_type,
        "in_channels": input_channels, "out_dim": out_dim}


def init_cls_model(num_classes: int, backbone_type: str,
                   input_channels: int = 1, **kwargs: Any
                   ) -> Tuple[nn.Module, Dict[str, Any]]:
    """A classification net + its metadict."""
    return ClassifierNet(input_channels, num_classes, backbone_type), {
        "model_type": "cls", "backbone": backbone_type,
        "in_channels": input_channels, "nb_classes": num_classes}


def init_mtask_cls_model(num_classes: Sequence[int], backbone_type: str,
                         input_channels: int = 1, **kwargs: Any
                         ) -> Tuple[nn.Module, Dict[str, Any]]:
    """A multitask classification net + its metadict."""
    return MultiTaskClassifierNet(input_channels, tuple(num_classes),
                                  backbone_type), {
        "model_type": "cls", "backbone": backbone_type,
        "in_channels": input_channels, "nb_classes": list(num_classes)}
