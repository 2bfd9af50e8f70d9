"""The weight bridge: a JAX Unet's variables -> the port's ``state_dict``.

Counterpart of `atomai_tpu/models/conversion.py:25-32` (which block is
which) and `:103-113` (layouts), run the other way. The JAX ``params`` and
``batch_stats`` trees arrive as nested dicts of numpy arrays (e.g. from
``jax.device_get``). Conv kernels go HWIO -> OIHW; BatchNorm
``scale/bias/mean/var`` become ``weight/bias/running_mean/running_var``.
numpy and torch only.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

# (port module, flax module) of the Unet without dilation
_UNET_BLOCKS = [("c1", "ConvBlock_0"), ("c2", "ConvBlock_1"),
                ("c3", "ConvBlock_2"), ("bn", "ConvBlock_3"),
                ("upsample_block1", "UpsampleBlock_0"),
                ("c4", "ConvBlock_4"),
                ("upsample_block2", "UpsampleBlock_1"),
                ("c5", "ConvBlock_5"),
                ("upsample_block3", "UpsampleBlock_2"),
                ("c6", "ConvBlock_6"), ("px", "Conv_0")]
# the blocks that hold a Dropout layer when the Unet has dropout on
_DROPOUT_BLOCKS = ("c3", "bn", "c4")


def _conv(sub: Mapping[str, Any], where: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(sub["kernel"], np.float32)
    if kernel.ndim != 4:
        raise ValueError(f"{where}: expected a 4D HWIO kernel, got shape "
                         f"{kernel.shape}")
    out = {"weight": torch.from_numpy(
        np.array(kernel.transpose(3, 2, 0, 1), order="C"))}
    if "bias" in sub:
        bias = np.asarray(sub["bias"], np.float32)
        if bias.shape != (kernel.shape[3],):
            raise ValueError(f"{where}: bias shape {bias.shape} does not "
                             f"match {kernel.shape[3]} output channels")
        out["bias"] = torch.from_numpy(bias.copy())
    return out


def _batch_norm(p: Mapping[str, Any], s: Mapping[str, Any], channels: int,
                where: str) -> Dict[str, torch.Tensor]:
    out = {}
    for src, dst, tree in (("scale", "weight", p), ("bias", "bias", p),
                           ("mean", "running_mean", s),
                           ("var", "running_var", s)):
        if src not in tree:
            raise ValueError(f"{where}: missing BatchNorm '{src}'")
        a = np.asarray(tree[src], np.float32)
        if a.shape != (channels,):
            raise ValueError(f"{where}: BatchNorm '{src}' has shape "
                             f"{a.shape}, expected ({channels},)")
        out[dst] = torch.from_numpy(a.copy())
    out["num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def _conv_block(p: Mapping[str, Any], s: Mapping[str, Any], dropout: bool,
                where: str) -> Dict[str, torch.Tensor]:
    n_layers = sum(1 for k in p if k.startswith("Conv_"))
    has_bn = "BatchNorm_0" in p
    # Sequential layout per layer: conv, (dropout), LeakyReLU, (BatchNorm)
    stride = 2 + int(dropout) + int(has_bn)
    out = {}
    for i in range(n_layers):
        conv = _conv(p[f"Conv_{i}"], f"{where}/Conv_{i}")
        out.update({f"block.{i * stride}.{k}": v for k, v in conv.items()})
        if has_bn:
            name = f"BatchNorm_{i}"
            if name not in p:
                raise ValueError(f"{where}: missing {name}")
            bn = _batch_norm(p[name], s.get(name, {}),
                             conv["weight"].shape[0], f"{where}/{name}")
            out.update({f"block.{i * stride + stride - 1}.{k}": v
                        for k, v in bn.items()})
    return out


def unet_from_jax(params: Mapping[str, Any],
                  batch_stats: Mapping[str, Any] = None,
                  dropout: bool = False) -> Dict[str, torch.Tensor]:
    """The port's Unet ``state_dict`` from a JAX Unet's ``params`` and
    ``batch_stats`` (nested dicts of arrays).

    ``dropout`` says whether the Unet was built with dropout on: it shifts
    the index of each layer in the port's ``nn.Sequential`` blocks and
    leaves no trace in the variables. Raises ``ValueError`` on a tree that
    is not a plain (undilated) Unet or whose shapes do not fit together.
    """
    batch_stats = batch_stats or {}
    expected = {flax for _, flax in _UNET_BLOCKS}
    if set(params) != expected:
        raise ValueError(
            "not the params of a plain JAX Unet: unexpected "
            f"{sorted(set(params) - expected)}, missing "
            f"{sorted(expected - set(params))}")
    state = {}
    for name, flax in _UNET_BLOCKS:
        if flax.startswith("ConvBlock"):
            sub = _conv_block(params[flax], batch_stats.get(flax, {}),
                              dropout and name in _DROPOUT_BLOCKS, flax)
        elif flax.startswith("UpsampleBlock"):
            conv = _conv(params[flax]["Conv_0"], f"{flax}/Conv_0")
            sub = {f"conv.{k}": v for k, v in conv.items()}
        else:  # the 1x1 pixel head
            sub = _conv(params[flax], flax)
        state.update({f"{name}.{k}": v for k, v in sub.items()})
    return state
