"""The plain reference of the served and trained net: AtomAI's default Unet.

A frozen, self-contained copy of the port's ``nets/fcnn.py`` ``Unet`` with
the same module names, so that a ``state_dict`` carries over both ways:
three max-pool levels, ``[conv -> LeakyReLU(0.01) -> BatchNorm]`` blocks,
bilinear 2x upsampling (half-pixel centres) + 1x1 conv, skips concatenated
as ``[skip, upsampled]``, a 1x1 pixel head. It runs in float32 with TF32
off (:func:`float32_exact`).

``quant`` (a dtype) makes it the control: every conv that the
configuration's policy runs in reduced precision (all but the pixel head)
runs on its input and weight rounded to that dtype and rounds its output
to it, as the policy's bf16 conv does in bf16; its backward rounds the
incoming gradient to ``GRAD_QUANT[quant]`` (float8_e5m2 for the float8
forward, the usual pair) and computes both gradients from the rounded
operands. Each rounding takes one scale a tensor, which puts its largest
magnitude at the dtype's largest finite value. The arithmetic between
roundings is float32. The pixel head, the BatchNorms and the upsampling
stay float32, as the policy keeps them.
"""

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


@contextlib.contextmanager
def float32_exact():
    """cuDNN and cuBLAS in true float32 (TF32 off) for the enclosed code."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


GRAD_QUANT = {torch.float8_e4m3fn: torch.float8_e5m2}


@torch.no_grad()
def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with a per-tensor scale, back in float32."""
    if dtype.itemsize == 1:
        scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
        return (t / scale).to(dtype).float() * scale
    return t.to(dtype).float()


class _RoundedConv(torch.autograd.Function):
    """A conv whose operands, output and incoming gradient are rounded."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dtype):
        xq, wq = rounded(x, dtype), rounded(w, dtype)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, GRAD_QUANT.get(dtype, dtype))
        return rounded(F.conv2d(xq, wq, b, stride, padding), dtype)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        stride, padding, gdtype = ctx.conf
        gq = rounded(gy, gdtype)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding)
        return gx, gw, gq.sum((0, 2, 3)), None, None, None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that the control rounds (``quant``)."""

    quant: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        return _RoundedConv.apply(x, self.weight, self.bias, self.stride,
                                  self.padding, self.quant)


class _Block(nn.Module):
    def __init__(self, nb_layers: int, cin: int, cout: int):
        super().__init__()
        layers = []
        for i in range(nb_layers):
            layers += [Conv2d(cin if i == 0 else cout, cout, 3, padding=1),
                       nn.LeakyReLU(0.01),
                       nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear",
                                       align_corners=False))


class Unet(nn.Module):
    """NCHW images -> NCHW logits (``nb_classes`` channels)."""

    def __init__(self, nb_classes: int = 1, nb_filters: int = 16,
                 layers: Sequence[int] = (1, 2, 2, 3)):
        super().__init__()
        nf, nbl = nb_filters, list(layers)
        self.c1 = _Block(nbl[0], 1, nf)
        self.c2 = _Block(nbl[1], nf, nf * 2)
        self.c3 = _Block(nbl[2], nf * 2, nf * 4)
        self.bn = _Block(nbl[3], nf * 4, nf * 8)
        self.upsample_block1 = _Up(nf * 8, nf * 4)
        self.c4 = _Block(nbl[2], nf * 8, nf * 4)
        self.upsample_block2 = _Up(nf * 4, nf * 2)
        self.c5 = _Block(nbl[1], nf * 4, nf * 2)
        self.upsample_block3 = _Up(nf * 2, nf)
        self.c6 = _Block(nbl[0], nf * 2, nf)
        self.px = nn.Conv2d(nf, nb_classes, 1)   # float32 in the policy

    def set_quant(self, dtype: Optional[torch.dtype]) -> "Unet":
        """Makes this net the control in ``dtype`` (None: the reference)."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.quant = dtype
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.c1(x)
        c2 = self.c2(F.max_pool2d(c1, 2, 2))
        c3 = self.c3(F.max_pool2d(c2, 2, 2))
        bn = self.bn(F.max_pool2d(c3, 2, 2))
        u3 = self.c4(torch.cat([c3, self.upsample_block1(bn)], dim=1))
        u2 = self.c5(torch.cat([c2, self.upsample_block2(u3)], dim=1))
        u1 = self.c6(torch.cat([c1, self.upsample_block3(u2)], dim=1))
        return self.px(u1.float())


def build(model: dict, device, quant: Optional[torch.dtype] = None) -> Unet:
    """The reference net of a configuration's ``model`` entry on ``device``
    (weights are loaded by the caller)."""
    if model.get("name") != "Unet":
        raise ValueError(f"the reference has no net {model.get('name')!r}")
    net = Unet(model["nb_classes"], model["nb_filters"], model["layers"])
    return net.to(device).set_quant(quant)
