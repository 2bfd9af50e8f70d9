"""Fully convolutional segmentation nets (NCHW).

Counterpart of `atomai_tpu/nets/fcnn.py:26-69, 166-221`. Only the Unet
without dilation is ported so far; the other architectures and the dilated
bottleneck are ROADMAP Queue 1 #2 follow-ups.
"""

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from .blocks import ConvBlock, UpsampleBlock, max_pool


class Unet(nn.Module):
    """3-level encoder/decoder with skip concatenations.

    Takes NCHW input, returns NCHW logits with ``nb_classes`` channels.
    Skips are concatenated as ``[skip, upsampled]``, the JAX order
    (`atomai_tpu/nets/fcnn.py:59, 63, 66`). The 1x1 pixel head runs in
    float32 outside any autocast region, as the JAX head (no ``dtype``)
    computes in float32 under the mixed policy.
    """

    def __init__(self, nb_classes: int = 1, nb_filters: int = 16,
                 dropout: bool = False, batch_norm: bool = True,
                 upsampling_mode: str = "bilinear",
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
        with torch.autocast(x.device.type, enabled=False):
            return self.px(u1.float())


# downsample factor of each ported architecture (static, as in the JAX
# package, `atomai_tpu/nets/fcnn.py:168`)
DOWNSAMPLE_FACTORS = {"Unet": 8}


def init_fcnn_model(model: str, nb_classes: int,
                    **kwargs: Any) -> Tuple[nn.Module, Dict[str, Any]]:
    """A segmentation net + its self-describing metadict (counterpart of
    `atomai_tpu/nets/fcnn.py:171-221`, "Unet" only)."""
    if model != "Unet":
        raise NotImplementedError(
            f"'{model}' is not ported yet; the port has 'Unet' "
            "(ROADMAP Queue 1 #2)")
    if kwargs.get("with_dilation", False):
        raise NotImplementedError(
            "Unet(with_dilation=True) is not ported yet (ROADMAP Queue 1 #2)")
    batch_norm = kwargs.get("batch_norm", True)
    dropout = kwargs.get("dropout", False)
    upsampling = kwargs.get("upsampling", "bilinear")
    nb_filters = kwargs.get("nb_filters", 16)
    layers = tuple(kwargs.get("layers", (1, 2, 2, 3)))
    net = Unet(nb_classes, nb_filters, dropout, batch_norm, upsampling,
               layers)
    meta_state_dict = {
        "model_type": "seg", "model": model, "nb_classes": nb_classes,
        "batch_norm": batch_norm, "dropout": dropout,
        "upsampling": upsampling, "with_dilation": False,
        "nb_filters": nb_filters, "layers": list(layers)}
    return net, meta_state_dict
