"""The weight bridge: JAX variables -> the port's ``state_dict``s.

Counterpart of `atomai_tpu/models/conversion.py:25-32` (which block is
which), `:103-113` (layouts) and `:320-366` (the VAE family's names), run
the other way. The JAX ``params`` and
``batch_stats`` trees arrive as nested dicts of numpy arrays (e.g. from
``jax.device_get``). Conv kernels go HWIO -> OIHW (1D: WIO -> OIW); Dense
kernels (in, out) -> (out, in); BatchNorm ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``. The nets covered: the
segmentation nets (Unet, dilated Unet, dilnet, SegResNet, ResHedNet), the
VAE family, SignalED (ImSpec), ensembles of a segmentation net or SignalED,
the denoiser, the regression and classification nets with every backbone
(the torchvision name maps are the port's own copy of
`atomai_tpu/models/conversion.py:546-612`), and the DKL models' feature
extractors and GP parameters. numpy and torch only.
"""

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

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


def _fcnn_layout(meta: Mapping[str, Any]):
    """(description, [(port module, flax module, kind)], the port modules
    that hold Dropout layers) of a segmentation net's metadict. Flax names
    each module type in call order, so a dilated bottleneck shifts the
    numbers of the Unet's later ConvBlocks."""
    model = meta.get("model", "Unet")
    dropout = bool(meta.get("dropout"))
    if model == "Unet":
        dil = bool(meta.get("with_dilation", False))
        cb = [f"ConvBlock_{i}" for i in range(7)]
        dec = cb[3:6] if dil else cb[4:7]
        blocks = [("c1", cb[0], "block"), ("c2", cb[1], "block"),
                  ("c3", cb[2], "block"),
                  ("bn", "DilatedBlock_0", "dilated") if dil
                  else ("bn", cb[3], "block"),
                  ("upsample_block1", "UpsampleBlock_0", "upsample"),
                  ("c4", dec[0], "block"),
                  ("upsample_block2", "UpsampleBlock_1", "upsample"),
                  ("c5", dec[1], "block"),
                  ("upsample_block3", "UpsampleBlock_2", "upsample"),
                  ("c6", dec[2], "block"), ("px", "Conv_0", "conv")]
        return (("dilated" if dil else "plain") + " JAX Unet", blocks,
                ("c3", "bn", "c4") if dropout else ())
    if model == "dilnet":
        return "JAX dilnet", [
            ("c1", "ConvBlock_0", "block"), ("at1", "DilatedBlock_0",
                                             "dilated"),
            ("at2", "DilatedBlock_1", "dilated"),
            ("up1", "UpsampleBlock_0", "upsample"),
            ("c2", "ConvBlock_1", "block"), ("px", "Conv_0", "conv")], \
            ("at1", "at2") if dropout else ()
    if model == "SegResNet":
        return "JAX SegResNet", [
            ("c1", "ConvBlock_0", "block"), ("c2", "ResModule_0", "res"),
            ("bn", "ResModule_1", "res"),
            ("upsample_block1", "UpsampleBlock_0", "upsample"),
            ("c3", "ResModule_2", "res"),
            ("upsample_block2", "UpsampleBlock_1", "upsample"),
            ("c4", "ConvBlock_1", "block"), ("px", "Conv_0", "conv")], ()
    if model == "ResHedNet":
        return "JAX ResHedNet", [
            ("net1", "ResModule_0", "res"), ("net2", "ResModule_1", "res"),
            ("net3", "ResModule_2", "res"), ("score1.0", "Conv_0", "conv"),
            ("score1.1", "BatchNorm_0", "bn"), ("score2.0", "Conv_1", "conv"),
            ("score2.1", "BatchNorm_1", "bn"), ("score3.0", "Conv_2", "conv"),
            ("score3.1", "BatchNorm_2", "bn"), ("fuse", "Conv_3", "conv")], ()
    raise ValueError(f"no weight bridge for a '{model}' segmentation net")


def _res_module(p: Mapping[str, Any], s: Mapping[str, Any],
                where: str) -> Dict[str, torch.Tensor]:
    """A ResModule: ``ResBlock_i`` -> ``c0.i``; in each block ``Conv_0``
    (the 1x1 projection), ``Conv_1``, ``BatchNorm_0``, ``Conv_2``,
    ``BatchNorm_1`` -> ``c0``, ``c1``, ``bn1``, ``c2``, ``bn2``."""
    out: Dict[str, torch.Tensor] = {}
    n = sum(1 for k in p if k.startswith("ResBlock_"))
    _expect(p, {f"ResBlock_{i}" for i in range(n)}, where)
    for i in range(n):
        bp, bs = p[f"ResBlock_{i}"], s.get(f"ResBlock_{i}", {})
        w = f"{where}/ResBlock_{i}"
        has_bn = "BatchNorm_0" in bp
        _expect(bp, {"Conv_0", "Conv_1", "Conv_2"} | (
            {"BatchNorm_0", "BatchNorm_1"} if has_bn else set()), w)
        for name, flax in (("c0", "Conv_0"), ("c1", "Conv_1"),
                           ("c2", "Conv_2")):
            _put(out, f"c0.{i}.{name}", _conv(bp[flax], f"{w}/{flax}"))
        if has_bn:
            c = out[f"c0.{i}.c0.weight"].shape[0]
            for name, flax in (("bn1", "BatchNorm_0"), ("bn2", "BatchNorm_1")):
                _put(out, f"c0.{i}.{name}", _batch_norm(
                    bp[flax], bs.get(flax, {}), c, f"{w}/{flax}"))
    return out


def _module(kind: str, p: Mapping[str, Any], s: Mapping[str, Any],
            dropout: bool, where: str) -> Dict[str, torch.Tensor]:
    """One module of a segmentation or denoising net, by ``kind``."""
    if kind == "block":
        return _conv_block(p, s, dropout, where)
    if kind == "dilated":
        return {"atrous_module" + k[len("block"):]: v for k, v in
                _conv_block(p, s, dropout, where).items()}
    if kind == "upsample":
        return {f"conv.{k}": v for k, v in
                _conv(p["Conv_0"], f"{where}/Conv_0").items()}
    if kind == "res":
        return _res_module(p, s, where)
    if kind == "conv":
        return _conv(p, where)
    # a BatchNorm of its own (ResHedNet's score heads)
    return _batch_norm(p, s, np.asarray(p["scale"]).shape[0], where)


def fcnn_from_jax(params: Mapping[str, Any],
                  batch_stats: Optional[Mapping[str, Any]],
                  meta: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a segmentation net (Unet with or
    without a dilated bottleneck, dilnet, SegResNet, ResHedNet) from the
    JAX net's ``params`` and ``batch_stats`` (nested dicts of arrays) and
    its metadict (``model``, ``dropout``, ``with_dilation``; the keys of
    ``init_fcnn_model``). ``dropout`` shifts the index of each layer in
    the port's ``nn.Sequential`` blocks and leaves no trace in the
    variables. Raises ``ValueError`` on a tree that does not fit the
    metadict or whose shapes do not fit together."""
    batch_stats = batch_stats or {}
    desc, blocks, dropout_blocks = _fcnn_layout(meta)
    expected = {flax for _, flax, _ in blocks}
    if set(params) != expected:
        raise ValueError(
            f"not the params of a {desc}: unexpected "
            f"{sorted(set(params) - expected)}, missing "
            f"{sorted(expected - set(params))}")
    state: Dict[str, torch.Tensor] = {}
    for name, flax, kind in blocks:
        _put(state, name, _module(kind, params[flax],
                                  batch_stats.get(flax, {}),
                                  name in dropout_blocks, flax))
    return state


def unet_from_jax(params: Mapping[str, Any],
                  batch_stats: Mapping[str, Any] = None,
                  dropout: bool = False) -> Dict[str, torch.Tensor]:
    """The port's Unet ``state_dict`` from a plain (undilated) JAX Unet's
    ``params`` and ``batch_stats``: :func:`fcnn_from_jax` for that Unet.
    Raises ``ValueError`` on a tree that is not a plain Unet or whose
    shapes do not fit together."""
    return fcnn_from_jax(params, batch_stats,
                         {"model": "Unet", "dropout": dropout})


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


def _nhwc_rows_to_nchw(weight: torch.Tensor, spatial: Tuple[int, ...],
                       c: int) -> torch.Tensor:
    """A head's (out, prod(spatial) * C) weight over channel-last
    flattened features -> over channel-first ones (2D or 1D)."""
    out = weight.shape[0]
    return weight.reshape((out,) + tuple(spatial) + (c,)).movedim(
        -1, 1).reshape(out, -1).contiguous()


def vae_from_jax(params: Mapping[str, Any], meta: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(encoder, decoder) ``state_dict``s of the port's VAE nets from the
    JAX package's ``{"encoder": ..., "decoder": ...}`` params and the
    model's metadict (``init_VAE_nets``' keys: ``coord``,
    ``conv_encoder``, ``conv_decoder``, ``discrete_dim``,
    ``numlayers_encoder``, ``numlayers_decoder``, ``numhidden_encoder``,
    ``in_dim``).

    Flax numbers its Dense layers in call order: an MLP encoder's trunk is
    ``Dense_0..Dense_{L-1}``, its heads ``Dense_L`` (``fc11``),
    ``Dense_{L+1}`` (``fc12``) and, for discrete latents,
    ``Dense_{L+2+k}`` (``fc13.k``); a conv encoder's are ``ConvBlock_0``,
    then ``Dense_0``, ``Dense_1`` and ``Dense_{2+k}``, whose rows read a
    channel-last flatten and are reordered to the port's channel-first
    one. Inside ``rDecoderNet``, ``coord_latent_0/Dense_0`` is
    ``fc_coord`` and ``Dense_1`` ``fc_latent`` (no bias), then
    ``Dense_0..Dense_{L-1}`` are the hidden layers and ``Dense_L`` the
    head; the conv decoder is ``Dense_0`` (``fc_linear``, no bias),
    ``ConvBlock_0`` (``decoder``) and ``Conv_0`` (``out``). Raises
    ``ValueError`` on a tree that does not fit the metadict.
    """
    enc_p, dec_p = params["encoder"], params["decoder"]
    conv = meta.get("conv_encoder", False)
    conv_d = meta.get("conv_decoder", False) and not meta.get("coord", 0)
    n_disc = len(meta.get("discrete_dim") or ())
    n_e, n_d = meta["numlayers_encoder"], meta["numlayers_decoder"]
    in_dim = tuple(meta["in_dim"])
    rank = 4 if len(in_dim) > 1 else 3
    n_heads = 2 + n_disc
    want_e = ({"ConvBlock_0"} | {f"Dense_{i}" for i in range(n_heads)}
              if conv else {f"Dense_{i}" for i in range(n_e + n_heads)})
    want_d = ({"Dense_0", "ConvBlock_0", "Conv_0"} if conv_d
              else {f"Dense_{i}" for i in range(n_d + 1)})
    if meta.get("coord", 0):
        want_d.add("coord_latent_0")
    for part, tree, want in (("encoder", enc_p, want_e),
                             ("decoder", dec_p, want_d)):
        if set(tree) != want:
            raise ValueError(f"{part} params {sorted(tree)} do not fit the "
                             f"metadict (expected {sorted(want)})")

    heads = ["fc11", "fc12"] + [f"fc13.{k}" for k in range(n_disc)]
    enc: Dict[str, torch.Tensor] = {}
    if conv:
        enc.update({f"conv.{k}": v for k, v in _conv_block(
            enc_p["ConvBlock_0"], {}, False, "encoder/ConvBlock_0",
            rank).items()})
        for i, name in enumerate(heads):
            d = _dense(enc_p[f"Dense_{i}"], f"encoder/Dense_{i}")
            d["weight"] = _nhwc_rows_to_nchw(
                d["weight"], in_dim[:rank - 2], meta["numhidden_encoder"])
            _put(enc, name, d)
    else:
        for i in range(n_e):
            _put(enc, f"dense.{2 * i}", _dense(enc_p[f"Dense_{i}"],
                                               f"encoder/Dense_{i}"))
        for i, name in enumerate(heads, n_e):
            _put(enc, name, _dense(enc_p[f"Dense_{i}"], f"encoder/Dense_{i}"))

    dec: Dict[str, torch.Tensor] = {}
    if conv_d:
        _put(dec, "fc_linear", _dense(dec_p["Dense_0"], "decoder/Dense_0",
                                      bias=False))
        dec.update({f"decoder.{k}": v for k, v in _conv_block(
            dec_p["ConvBlock_0"], {}, False, "decoder/ConvBlock_0",
            rank).items()})
        _put(dec, "out", _conv(dec_p["Conv_0"], "decoder/Conv_0", rank))
        return enc, dec
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
    "seg" (a segmentation net) or "imspec" (a SignalED)."""
    kind = meta.get("model_type")
    if kind not in ("seg", "imspec"):
        raise ValueError(f"no weight bridge for a '{kind}' ensemble")
    out = {}
    for k, member in ensemble.items():
        if isinstance(member, Mapping) and "params" in member:
            p, s = member["params"], member.get("batch_stats")
        else:
            p, s = member, None
        out[int(k)] = (fcnn_from_jax(p, s, meta) if kind == "seg"
                       else signal_ed_from_jax(p, s, meta))
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


def denoiser_from_jax(params: Mapping[str, Any],
                      batch_stats: Optional[Mapping[str, Any]],
                      meta: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``DenoiserNet`` ``state_dict`` from the JAX net's
    ``params`` and ``batch_stats`` and the model's metadict
    (``encoder_filters``, ``decoder_filters``). Flax numbers the
    ConvBlocks in call order: the encoder's first, then the decoder's,
    with ``UpsampleBlock_{i-1}`` before decoder block i > 0; ``Conv_0`` is
    the head."""
    batch_stats = batch_stats or {}
    n_enc, n_dec = len(meta["encoder_filters"]), len(meta["decoder_filters"])
    blocks = [(f"encoder.{i}", f"ConvBlock_{i}", "block")
              for i in range(n_enc)]
    for i in range(n_dec):
        if i > 0:
            blocks.append((f"upsample.{i - 1}", f"UpsampleBlock_{i - 1}",
                           "upsample"))
        blocks.append((f"decoder.{i}", f"ConvBlock_{n_enc + i}", "block"))
    blocks.append(("out", "Conv_0", "conv"))
    _expect(params, {flax for _, flax, _ in blocks}, "denoiser")
    state: Dict[str, torch.Tensor] = {}
    for name, flax, kind in blocks:
        _put(state, name, _module(kind, params[flax],
                                  batch_stats.get(flax, {}), False, flax))
    return state


def _resnet50_names():
    """(torchvision key, flax path, kind) of ResNet50's layers."""
    specs = [("conv1", ("conv1",), "conv"), ("bn1", ("bn1",), "bn")]
    for li, nblocks in [(1, 3), (2, 4), (3, 6), (4, 3)]:
        for b in range(nblocks):
            base, blk = f"layer{li}.{b}", f"layer{li}_{b}"
            for j in (1, 2, 3):
                specs += [(f"{base}.conv{j}", (blk, f"conv{j}"), "conv"),
                          (f"{base}.bn{j}", (blk, f"bn{j}"), "bn")]
            if b == 0:
                specs += [(f"{base}.downsample.0", (blk, "downsample_conv"),
                           "conv"),
                          (f"{base}.downsample.1", (blk, "downsample_bn"),
                           "bn")]
    return specs


def _vgg16_names():
    """vgg16.features' convs by Sequential index."""
    return [(str(i), (f"conv{i}",), "conv")
            for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)]


def _mobilenet_v2_names():
    """mobilenet_v2.features: 0 the stem, 1-17 the inverted residuals
    (no expansion in the first), 18 the 1x1 head."""
    specs = [("0.0", ("stem_conv",), "conv"), ("0.1", ("stem_bn",), "bn")]
    bi = 1
    for t, n in [(1, 1), (6, 2), (6, 3), (6, 4), (6, 3), (6, 3), (6, 1)]:
        for _ in range(n):
            blk = f"block{bi}"
            parts = [] if t == 1 else [("conv.0.0", "pw"),
                                       ("conv.0.1", "pw_bn")]
            d = 0 if t == 1 else 1
            parts += [(f"conv.{d}.0", "dw"), (f"conv.{d}.1", "dw_bn"),
                      (f"conv.{d + 1}", "project"),
                      (f"conv.{d + 2}", "project_bn")]
            specs += [(f"{bi}.{k}", (blk, f), "bn" if f.endswith("_bn")
                       else "conv") for k, f in parts]
            bi += 1
    return specs + [("18.0", ("head_conv",), "conv"),
                    ("18.1", ("head_bn",), "bn")]


BACKBONE_NAMES = {"resnet": _resnet50_names, "vgg": _vgg16_names,
                  "mobilenet": _mobilenet_v2_names}


def _backbone(p: Mapping[str, Any], s: Mapping[str, Any],
              backbone: str) -> Dict[str, torch.Tensor]:
    """A ``ConvBackbone``'s ``state_dict`` from its JAX variables."""
    out: Dict[str, torch.Tensor] = {}
    if backbone in BACKBONE_NAMES:
        _expect(p, {"features"}, "ConvBackbone_0")
        p, s = p["features"], s.get("features", {})
        for key, path, kind in BACKBONE_NAMES[backbone]():
            sub_p, sub_s = p, s
            for part in path:
                sub_p, sub_s = sub_p[part], sub_s.get(part, {})
            where = "features/" + "/".join(path)
            _put(out, f"features.{key}", _conv(sub_p, where)
                 if kind == "conv" else _batch_norm(
                     sub_p, sub_s, np.asarray(sub_p["scale"]).shape[0],
                     where))
        return out
    n = sum(1 for k in p if k.startswith("Conv_"))
    _expect(p, {f"{k}_{i}" for i in range(n)
                for k in ("Conv", "BatchNorm")}, "ConvBackbone_0")
    for i in range(n):
        conv = _conv(p[f"Conv_{i}"], f"ConvBackbone_0/Conv_{i}")
        _put(out, f"convs.{i}", conv)
        _put(out, f"bns.{i}", _batch_norm(
            p[f"BatchNorm_{i}"], s.get(f"BatchNorm_{i}", {}),
            conv["weight"].shape[0], f"ConvBackbone_0/BatchNorm_{i}"))
    return out


def reg_cls_from_jax(params: Mapping[str, Any],
                     batch_stats: Optional[Mapping[str, Any]],
                     meta: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``RegressorNet``, ``ClassifierNet`` or
    ``MultiTaskClassifierNet`` ``state_dict`` from the JAX net's ``params``
    and ``batch_stats`` and the model's metadict (``model_type`` "reg" or
    "cls", ``backbone``; ``nb_classes`` a list for multitask). The
    torchvision backbones' variables go through :data:`BACKBONE_NAMES`,
    the slim presets' ``Conv_i``/``BatchNorm_i`` to ``convs.i``/``bns.i``;
    ``Dense_t`` is head t."""
    batch_stats = batch_stats or {}
    kind = meta.get("model_type")
    if kind == "reg":
        heads = ["output_layer"]
    elif kind == "cls":
        nb = meta["nb_classes"]
        heads = ([f"output_layers.{t}.0" for t in range(len(nb))]
                 if isinstance(nb, (list, tuple)) else ["output_layer.0"])
    else:
        raise ValueError(f"no weight bridge for a '{kind}' model")
    _expect(params, {"ConvBackbone_0"} | {f"Dense_{t}" for t in
                                          range(len(heads))}, "reg/cls")
    state = {f"backbone.{k}": v for k, v in _backbone(
        params["ConvBackbone_0"], batch_stats.get("ConvBackbone_0", {}),
        meta.get("backbone", "mobilenet")).items()}
    for t, name in enumerate(heads):
        _put(state, name, _dense(params[f"Dense_{t}"], f"Dense_{t}"))
    return state
