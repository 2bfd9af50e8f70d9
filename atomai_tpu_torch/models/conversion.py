"""The weight bridge: JAX variables -> the port's ``state_dict``s.

Counterpart of `atomai_tpu/models/conversion.py:25-32` (which block is
which), `:103-113` (layouts) and `:320-366` (the VAE family's names), run
the other way. The JAX ``params`` and
``batch_stats`` trees arrive as nested dicts of numpy arrays (e.g. from
``jax.device_get``). Conv kernels go HWIO -> OIHW (1D: WIO -> OIW); Dense
kernels (in, out) -> (out, in); BatchNorm ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``. The nets covered: the Unet, the
VAE family, SignalED (ImSpec), ensembles of the Unet or SignalED, and the
DKL models' feature extractors and GP parameters. numpy and torch only.
"""

from typing import Any, Dict, Mapping, Optional, Tuple

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


_LAYOUT = {4: ((3, 2, 0, 1), "4D HWIO"), 3: ((2, 1, 0), "3D WIO")}


def _conv(sub: Mapping[str, Any], where: str,
          rank: int = 4) -> Dict[str, torch.Tensor]:
    """A conv's weight (and bias); ``rank`` 4 for 2D convs, 3 for 1D."""
    kernel = np.asarray(sub["kernel"], np.float32)
    axes, name = _LAYOUT[rank]
    if kernel.ndim != rank:
        raise ValueError(f"{where}: expected a {name} kernel, got shape "
                         f"{kernel.shape}")
    out = {"weight": torch.from_numpy(
        np.array(kernel.transpose(axes), order="C"))}
    if "bias" in sub:
        bias = np.asarray(sub["bias"], np.float32)
        if bias.shape != (kernel.shape[-1],):
            raise ValueError(f"{where}: bias shape {bias.shape} does not "
                             f"match {kernel.shape[-1]} output channels")
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
                where: str, rank: int = 4) -> Dict[str, torch.Tensor]:
    n_layers = sum(1 for k in p if k.startswith("Conv_"))
    has_bn = "BatchNorm_0" in p
    # Sequential layout per layer: conv, (dropout), LeakyReLU, (BatchNorm)
    stride = 2 + int(dropout) + int(has_bn)
    out = {}
    for i in range(n_layers):
        conv = _conv(p[f"Conv_{i}"], f"{where}/Conv_{i}", rank)
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


def _dense(sub: Mapping[str, Any], where: str,
           bias: bool = True) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(sub["kernel"], np.float32)
    if kernel.ndim != 2:
        raise ValueError(f"{where}: expected a 2D (in, out) Dense kernel, "
                         f"got shape {kernel.shape}")
    out = {"weight": torch.from_numpy(np.array(kernel.T, order="C"))}
    if bias:
        b = np.asarray(sub["bias"], np.float32)
        if b.shape != (kernel.shape[1],):
            raise ValueError(f"{where}: bias shape {b.shape} does not match "
                             f"{kernel.shape[1]} outputs")
        out["bias"] = torch.from_numpy(b.copy())
    elif "bias" in sub:
        raise ValueError(f"{where}: unexpected bias")
    return out


def _put(state: Dict[str, torch.Tensor], name: str,
         tensors: Dict[str, torch.Tensor]) -> None:
    state.update({f"{name}.{k}": v for k, v in tensors.items()})


def _nhwc_rows_to_nchw(weight: torch.Tensor, hw: Tuple[int, int],
                       c: int) -> torch.Tensor:
    """A head's (out, H*W*C) weight over NHWC-flattened features ->
    over NCHW-flattened ones."""
    out = weight.shape[0]
    return weight.reshape(out, hw[0], hw[1], c).permute(
        0, 3, 1, 2).reshape(out, -1).contiguous()


def vae_from_jax(params: Mapping[str, Any], meta: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(encoder, decoder) ``state_dict``s of the port's VAE nets from the
    JAX package's ``{"encoder": ..., "decoder": ...}`` params and the
    model's metadict (``init_VAE_nets``' keys: ``coord``,
    ``conv_encoder``, ``numlayers_encoder``, ``numlayers_decoder``,
    ``numhidden_encoder``, ``in_dim``).

    Flax numbers its Dense layers in call order: the encoder's trunk is
    ``Dense_0..Dense_{L-1}`` and its heads ``Dense_L`` (``fc11``) and
    ``Dense_{L+1}`` (``fc12``); inside ``rDecoderNet``,
    ``coord_latent_0/Dense_0`` is ``fc_coord`` and ``Dense_1``
    ``fc_latent`` (no bias), then ``Dense_0..Dense_{L-1}`` are the hidden
    layers and ``Dense_L`` the head. Raises ``ValueError`` on a tree that
    does not fit the metadict.
    """
    if meta.get("discrete_dim"):
        raise ValueError("discrete latents (jVAE, jrVAE) are not ported yet")
    enc_p, dec_p = params["encoder"], params["decoder"]
    conv = meta.get("conv_encoder", False)
    n_e, n_d = meta["numlayers_encoder"], meta["numlayers_decoder"]
    want_e = ({"ConvBlock_0", "Dense_0", "Dense_1"} if conv
              else {f"Dense_{i}" for i in range(n_e + 2)})
    want_d = {f"Dense_{i}" for i in range(n_d + 1)}
    if meta.get("coord", 0):
        want_d.add("coord_latent_0")
    for part, tree, want in (("encoder", enc_p, want_e),
                             ("decoder", dec_p, want_d)):
        if set(tree) != want:
            raise ValueError(f"{part} params {sorted(tree)} do not fit the "
                             f"metadict (expected {sorted(want)})")

    enc: Dict[str, torch.Tensor] = {}
    if conv:
        in_dim = tuple(meta["in_dim"])
        enc.update({f"conv.{k}": v for k, v in _conv_block(
            enc_p["ConvBlock_0"], {}, False, "encoder/ConvBlock_0").items()})
        for name, flax in (("fc11", "Dense_0"), ("fc12", "Dense_1")):
            d = _dense(enc_p[flax], f"encoder/{flax}")
            d["weight"] = _nhwc_rows_to_nchw(
                d["weight"], in_dim[:2], meta["numhidden_encoder"])
            _put(enc, name, d)
    else:
        for i in range(n_e):
            _put(enc, f"dense.{2 * i}", _dense(enc_p[f"Dense_{i}"],
                                               f"encoder/Dense_{i}"))
        for name, i in (("fc11", n_e), ("fc12", n_e + 1)):
            _put(enc, name, _dense(enc_p[f"Dense_{i}"], f"encoder/Dense_{i}"))

    dec: Dict[str, torch.Tensor] = {}
    trunk = "decoder"
    if meta.get("coord", 0):
        cl = dec_p["coord_latent_0"]
        _put(dec, "coord_latent.fc_coord",
             _dense(cl["Dense_0"], "decoder/coord_latent_0/Dense_0"))
        _put(dec, "coord_latent.fc_latent",
             _dense(cl["Dense_1"], "decoder/coord_latent_0/Dense_1",
                    bias=False))
        trunk = "fc_decoder"
    for i in range(n_d):
        _put(dec, f"{trunk}.{2 * i}", _dense(dec_p[f"Dense_{i}"],
                                             f"decoder/Dense_{i}"))
    _put(dec, "out", _dense(dec_p[f"Dense_{n_d}"], f"decoder/Dense_{n_d}"))
    return enc, dec


def _expect(tree: Mapping[str, Any], want, where: str) -> None:
    if set(tree) != set(want):
        raise ValueError(f"{where} params {sorted(tree)} do not fit the "
                         f"metadict (expected {sorted(want)})")


def signal_ed_from_jax(params: Mapping[str, Any],
                       batch_stats: Optional[Mapping[str, Any]],
                       meta: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's SignalED ``state_dict`` from the JAX SignalED's
    ``params`` and ``batch_stats`` and the model's metadict
    (``init_imspec_model``' keys; ``decoder_upsampling`` decides the
    decoder's layout).

    Flax names the decoder's blocks in call order: with upsampling,
    ``ConvBlock_0`` and ``ConvBlock_1`` are the two upsampling steps and
    ``ConvBlock_2`` the block to one channel; without, that block is
    ``ConvBlock_0``. ``DilatedBlock_0`` numbers its convs and BatchNorms as
    a ConvBlock does. Raises ``ValueError`` on a tree that does not fit.
    """
    batch_stats = batch_stats or {}
    enc_p, dec_p = params["encoder"], params["decoder"]
    enc_s = batch_stats.get("encoder", {})
    dec_s = batch_stats.get("decoder", {})
    up = bool(meta.get("decoder_upsampling", False))
    # conv kernel ranks: 1D signals have WIO kernels, 2D ones HWIO
    enc_rank = len(tuple(meta["in_dim"])) + 2
    dec_rank = len(tuple(meta["out_dim"])) + 2
    _expect(enc_p, {"ConvBlock_0", "Dense_0"}, "encoder")
    dec_blocks = ([("deconv1", "ConvBlock_0"), ("deconv2", "ConvBlock_1"),
                   ("conv", "ConvBlock_2")] if up
                  else [("conv", "ConvBlock_0")])
    _expect(dec_p, {f for _, f in dec_blocks} | {"Dense_0", "DilatedBlock_0",
                                                 "Conv_0"}, "decoder")
    state: Dict[str, torch.Tensor] = {}
    _put(state, "encoder.conv", _conv_block(
        enc_p["ConvBlock_0"], enc_s.get("ConvBlock_0", {}), False,
        "encoder/ConvBlock_0", enc_rank))
    _put(state, "encoder.fc", _dense(enc_p["Dense_0"], "encoder/Dense_0"))
    _put(state, "decoder.fc", _dense(dec_p["Dense_0"], "decoder/Dense_0"))
    for name, flax in dec_blocks:
        _put(state, f"decoder.{name}", _conv_block(
            dec_p[flax], dec_s.get(flax, {}), False, f"decoder/{flax}",
            dec_rank))
    dil = _conv_block(dec_p["DilatedBlock_0"], dec_s.get("DilatedBlock_0", {}),
                      False, "decoder/DilatedBlock_0", dec_rank)
    _put(state, "decoder.dilblock", {
        "atrous_module" + k[len("block"):]: v for k, v in dil.items()})
    _put(state, "decoder.out", _conv(dec_p["Conv_0"], "decoder/Conv_0",
                                     dec_rank))
    return state


def ensemble_from_jax(ensemble: Mapping[Any, Any], meta: Mapping[str, Any]
                      ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The port's members (``{i: state_dict}``) from a JAX
    ``ensemble_state_dict``: members are ``{"params", "batch_stats"}``
    (each with its own BatchNorm statistics), or bare params for nets
    without BatchNorm. ``meta`` is the ensemble's metadict: ``model_type``
    "seg" (a Unet) or "imspec" (a SignalED)."""
    kind = meta.get("model_type")
    if kind not in ("seg", "imspec"):
        raise ValueError(f"no weight bridge for a '{kind}' ensemble")
    out = {}
    for k, member in ensemble.items():
        if isinstance(member, Mapping) and "params" in member:
            p, s = member["params"], member.get("batch_stats")
        else:
            p, s = member, None
        out[int(k)] = (unet_from_jax(p, s, dropout=meta.get("dropout", False))
                       if kind == "seg" else signal_ed_from_jax(p, s, meta))
    return dict(sorted(out.items()))


_GP_NAMES = ("raw_lengthscale", "raw_outputscale", "raw_noise", "mean_const")


def dkl_from_jax(fe_params: Mapping[str, Any], gp_params: Mapping[str, Any],
                 meta: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(extractor ``state_dict``, GP params) of the port's DKL models from a
    JAX ``dklGPTrainer``'s ``fe_params`` and ``gp_params`` and its
    ``dimdict`` (``input_dim``, ``embedim``).

    An fc extractor's ``Dense_i`` kernel (in, out) becomes ``layers.i``'s
    weight (out, in); a tree with a leading member axis (kernels
    (b, in, out), independent outputs and ensembles) becomes a
    ``StackedFeatureExtractor``'s ``kernels.i`` and ``biases.i`` as they
    are. The raw GP parameters are copied as they are. Raises
    ``ValueError`` on a tree that does not fit the dimdict.
    """
    n = len(fe_params)
    _expect(fe_params, {f"Dense_{i}" for i in range(n)}, "feature extractor")
    kernels = [np.asarray(fe_params[f"Dense_{i}"]["kernel"], np.float32)
               for i in range(n)]
    stacked = kernels[0].ndim == 3
    if (kernels[0].shape[-2] != meta["input_dim"]
            or kernels[-1].shape[-1] != meta["embedim"]):
        raise ValueError(f"extractor kernels {[k.shape for k in kernels]} "
                         f"do not map {meta['input_dim']} inputs to "
                         f"{meta['embedim']} embedding dims")
    fe: Dict[str, torch.Tensor] = {}
    for i, k in enumerate(kernels):
        where = f"feature extractor/Dense_{i}"
        if stacked:
            b = np.asarray(fe_params[f"Dense_{i}"]["bias"], np.float32)
            if k.ndim != 3 or b.shape != (k.shape[0], k.shape[2]):
                raise ValueError(f"{where}: kernel {k.shape} and bias "
                                 f"{b.shape} are not member-stacked")
            fe[f"kernels.{i}"] = torch.from_numpy(np.array(k))
            fe[f"biases.{i}"] = torch.from_numpy(np.array(b))
        else:
            _put(fe, f"layers.{i}", _dense(fe_params[f"Dense_{i}"], where))
    _expect(gp_params, _GP_NAMES, "GP")
    gp = {k: torch.from_numpy(np.array(gp_params[k], np.float32))
          for k in _GP_NAMES}
    return fe, gp
