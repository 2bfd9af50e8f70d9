"""Fully convolutional segmentation nets (NCHW).

Counterpart of `atomai_tpu/nets/fcnn.py:26-221`: the Unet (with or without
a dilated bottleneck), dilnet, ResHedNet and SegResNet, their downsample
factors, and ``init_fcnn_model``, which also takes a user's ``nn.Module``.
Each net takes NCHW input and returns NCHW logits with ``nb_classes``
channels. Skips are concatenated as ``[skip, upsampled]``, the JAX order.
The layers the JAX package builds without a ``dtype`` (the 1x1 pixel
heads, ResHedNet's score heads and their BatchNorms) compute in float32:
here they run outside any autocast region.
"""

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.dtypes import head_f32
from .blocks import (ConvBlock, DilatedBlock, ResModule, UpsampleBlock,
                     max_pool)


class Unet(nn.Module):
    """3-level encoder/decoder with skip concatenations; with
    ``with_dilation`` the bottleneck is a :class:`DilatedBlock` with
    dilations 2, 4, ..., 2 * ``layers[-1]``
    (`atomai_tpu/nets/fcnn.py:26-69`)."""

    def __init__(self, nb_classes: int = 1, nb_filters: int = 16,
                 dropout: bool = False, batch_norm: bool = True,
                 upsampling_mode: str = "bilinear",
                 with_dilation: bool = False,
                 layers: Tuple[int, ...] = (1, 2, 2, 3)):
        super().__init__()
        nbl = list(layers)
        dropout_vals = [.1, .2, .1] if dropout else [0, 0, 0]
        nf = nb_filters
        bn = dict(batch_norm=batch_norm)
        self.nb_classes = nb_classes
        self.c1 = ConvBlock(2, nbl[0], 1, nf, **bn)
        self.c2 = ConvBlock(2, nbl[1], nf, nf * 2, **bn)
        self.c3 = ConvBlock(2, nbl[2], nf * 2, nf * 4,
                            dropout_=dropout_vals[0], **bn)
        if with_dilation:
            dil = list(range(2, 2 * nbl[3] + 1, 2))
            self.bn = DilatedBlock(2, nf * 4, nf * 8, dil, dil,
                                   dropout_=dropout_vals[1], **bn)
        else:
            self.bn = ConvBlock(2, nbl[3], nf * 4, nf * 8,
                                dropout_=dropout_vals[1], **bn)
        self.upsample_block1 = UpsampleBlock(2, nf * 8, nf * 4,
                                             mode=upsampling_mode)
        self.c4 = ConvBlock(2, nbl[2], nf * 8, nf * 4,
                            dropout_=dropout_vals[2], **bn)
        self.upsample_block2 = UpsampleBlock(2, nf * 4, nf * 2,
                                             mode=upsampling_mode)
        self.c5 = ConvBlock(2, nbl[1], nf * 4, nf * 2, **bn)
        self.upsample_block3 = UpsampleBlock(2, nf * 2, nf,
                                             mode=upsampling_mode)
        self.c6 = ConvBlock(2, nbl[0], nf * 2, nf, **bn)
        self.px = nn.Conv2d(nf, nb_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.c1(x)
        c2 = self.c2(max_pool(c1))
        c3 = self.c3(max_pool(c2))
        bn = self.bn(max_pool(c3))
        u3 = self.c4(torch.cat([c3, self.upsample_block1(bn)], dim=1))
        u2 = self.c5(torch.cat([c2, self.upsample_block2(u3)], dim=1))
        u1 = self.c6(torch.cat([c1, self.upsample_block3(u2)], dim=1))
        return head_f32(self.px, u1)


class dilnet(nn.Module):
    """One max pool, two dilated cascades (dilations 2..2 * ``layers[1]``
    and 2..2 * ``layers[2]``), one upsampling with a skip
    (`atomai_tpu/nets/fcnn.py:72-99`)."""

    def __init__(self, nb_classes: int = 1, nb_filters: int = 25,
                 dropout: bool = False, batch_norm: bool = True,
                 upsampling_mode: str = "bilinear",
                 layers: Tuple[int, ...] = (1, 3, 3, 1)):
        super().__init__()
        nbl = list(layers)
        dil1 = list(range(2, 2 * nbl[1] + 1, 2))
        dil2 = list(range(2, 2 * nbl[2] + 1, 2))
        dropout_vals = [.3, .3] if dropout else [0, 0]
        nf = nb_filters
        self.nb_classes = nb_classes
        self.c1 = ConvBlock(2, nbl[0], 1, nf, batch_norm=batch_norm)
        self.at1 = DilatedBlock(2, nf, nf * 2, dil1, dil1,
                                batch_norm=batch_norm,
                                dropout_=dropout_vals[0])
        self.at2 = DilatedBlock(2, nf * 2, nf * 2, dil2, dil2,
                                batch_norm=batch_norm,
                                dropout_=dropout_vals[1])
        self.up1 = UpsampleBlock(2, nf * 2, nf, mode=upsampling_mode)
        self.c2 = ConvBlock(2, nbl[3], nf * 2, nf, batch_norm=batch_norm)
        self.px = nn.Conv2d(nf, nb_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.c1(x)
        at2 = self.at2(self.at1(max_pool(c1)))
        u1 = self.c2(torch.cat([c1, self.up1(at2)], dim=1))
        return head_f32(self.px, u1)


class ResHedNet(nn.Module):
    """Holistically-nested edge detector with residual modules: three
    scales, each with a 1x1 score head and BatchNorm; the coarser two
    resized to the input's size (bilinear with half-pixel centres, or
    nearest), concatenated and fused by a 1x1 conv
    (`atomai_tpu/nets/fcnn.py:102-134`). Always with BatchNorm."""

    def __init__(self, nb_classes: int = 1, nb_filters: int = 64,
                 upsampling_mode: str = "bilinear",
                 layers: Tuple[int, ...] = (3, 4, 5)):
        super().__init__()
        nbl = list(layers)
        nf = nb_filters
        self.nb_classes = nb_classes
        # jax.image.resize "nearest" samples at half-pixel centres, as
        # torch's "nearest-exact" does
        self.mode = "bilinear" if upsampling_mode == "bilinear" \
            else "nearest-exact"
        self.net1 = ResModule(2, nbl[0], 1, nf)
        self.net2 = ResModule(2, nbl[1], nf, nf * 2)
        self.net3 = ResModule(2, nbl[2], nf * 2, nf * 4)
        self.score1, self.score2, self.score3 = (
            nn.Sequential(nn.Conv2d(c, nb_classes, 1),
                          nn.BatchNorm2d(nb_classes))
            for c in (nf, nf * 2, nf * 4))
        self.fuse = nn.Conv2d(3 * nb_classes, nb_classes, 1)

    def _resize(self, s: torch.Tensor, size) -> torch.Tensor:
        return F.interpolate(s, size=size, mode=self.mode,
                             align_corners=False if self.mode == "bilinear"
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n1 = self.net1(x)
        n2 = self.net2(max_pool(n1))
        n3 = self.net3(max_pool(n2))
        size = x.shape[2:]
        with torch.autocast(x.device.type, enabled=False):
            s1 = self.score1(n1.float())
            s2 = self._resize(self.score2(n2.float()), size)
            s3 = self._resize(self.score3(n3.float()), size)
            return self.fuse(torch.cat([s1, s2, s3], dim=1))


class SegResNet(nn.Module):
    """SegNet-like encoder/decoder of residual modules with two skips
    (`atomai_tpu/nets/fcnn.py:137-164`)."""

    def __init__(self, nb_classes: int = 1, nb_filters: int = 32,
                 batch_norm: bool = True, upsampling_mode: str = "bilinear",
                 layers: Tuple[int, ...] = (2, 2, 2)):
        super().__init__()
        nbl = list(layers)
        nf = nb_filters
        bn = dict(batch_norm=batch_norm)
        self.nb_classes = nb_classes
        self.c1 = ConvBlock(2, 1, 1, nf, **bn)
        self.c2 = ResModule(2, nbl[0], nf, nf * 2, **bn)
        self.bn = ResModule(2, nbl[1], nf * 2, nf * 4, **bn)
        self.upsample_block1 = UpsampleBlock(2, nf * 4, nf * 2,
                                             mode=upsampling_mode)
        self.c3 = ResModule(2, nbl[2], nf * 4, nf * 2, **bn)
        self.upsample_block2 = UpsampleBlock(2, nf * 2, nf,
                                             mode=upsampling_mode)
        self.c4 = ConvBlock(2, 1, nf * 2, nf, **bn)
        self.px = nn.Conv2d(nf, nb_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.c1(x)
        c2 = self.c2(max_pool(c1))
        bn = self.bn(max_pool(c2))
        u2 = self.c3(torch.cat([c2, self.upsample_block1(bn)], dim=1))
        u1 = self.c4(torch.cat([c1, self.upsample_block2(u2)], dim=1))
        return head_f32(self.px, u1)


# downsample factor of each architecture (static, as in the JAX package,
# `atomai_tpu/nets/fcnn.py:168`): the predictor pads frames to a multiple
DOWNSAMPLE_FACTORS = {"Unet": 8, "dilnet": 2, "SegResNet": 4, "ResHedNet": 4}


def init_fcnn_model(model: Union[str, nn.Module], nb_classes: int,
                    **kwargs: Any) -> Tuple[nn.Module, Dict[str, Any]]:
    """A segmentation net + its self-describing metadict (counterpart of
    `atomai_tpu/nets/fcnn.py:171-221`, the same keys and defaults). A
    user's ``nn.Module`` is returned as it is, with the metadict of a
    "custom" model; it takes NCHW images and returns NCHW logits."""
    if isinstance(model, nn.Module):
        return model, {"model_type": "seg", "model": "custom",
                       "nb_classes": nb_classes}
    batch_norm = kwargs.get("batch_norm", True)
    dropout = kwargs.get("dropout", False)
    upsampling = kwargs.get("upsampling", "bilinear")
    meta_state_dict = {
        "model_type": "seg", "model": model, "nb_classes": nb_classes,
        "batch_norm": batch_norm, "dropout": dropout,
        "upsampling": upsampling}
    if model == "Unet":
        with_dilation = kwargs.get("with_dilation", False)
        nb_filters = kwargs.get("nb_filters", 16)
        layers = kwargs.get("layers", [1, 2, 2, 3])
        net = Unet(nb_classes, nb_filters, dropout, batch_norm, upsampling,
                   with_dilation, tuple(layers))
        meta_state_dict["with_dilation"] = with_dilation
    elif model == "dilnet":
        nb_filters = kwargs.get("nb_filters", 25)
        layers = kwargs.get("layers", [1, 3, 3, 1])
        net = dilnet(nb_classes, nb_filters, dropout, batch_norm,
                     upsampling, tuple(layers))
    elif model == "SegResNet":
        nb_filters = kwargs.get("nb_filters", 32)
        layers = kwargs.get("layers", [2, 2, 2])
        net = SegResNet(nb_classes, nb_filters, batch_norm, upsampling,
                        tuple(layers))
    elif model == "ResHedNet":
        nb_filters = kwargs.get("nb_filters", 64)
        layers = kwargs.get("layers", [3, 4, 5])
        net = ResHedNet(nb_classes, nb_filters, upsampling, tuple(layers))
    else:
        raise NotImplementedError(
            "Currently implemented models are 'Unet', 'dilnet', "
            "'SegResNet', and 'ResHedNet'")
    if model in ("ResHedNet", "SegResNet"):
        meta_state_dict["dropout"] = None
    if model == "ResHedNet":
        meta_state_dict["batch_norm"] = True
    meta_state_dict["nb_filters"] = nb_filters
    meta_state_dict["layers"] = list(layers)
    return net, meta_state_dict
