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


def _f32(a) -> np.ndarray:
    """A float32 numpy copy of an array leaf (numpy, or a CPU tensor such
    as the bfloat16 leaves of a ``.aoi`` file)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _conv(sub: Mapping[str, Any], where: str,
          rank: int = 4) -> Dict[str, torch.Tensor]:
    """A conv's weight (and bias); ``rank`` 4 for 2D convs, 3 for 1D."""
    kernel = _f32(sub["kernel"])
    axes, name = _LAYOUT[rank]
    if kernel.ndim != rank:
        raise ValueError(f"{where}: expected a {name} kernel, got shape "
                         f"{kernel.shape}")
    out = {"weight": torch.from_numpy(
        np.array(kernel.transpose(axes), order="C"))}
    if "bias" in sub:
        bias = _f32(sub["bias"])
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
        a = _f32(tree[src])
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
    return _batch_norm(p, s, len(p["scale"]), where)


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
    kernel = _f32(sub["kernel"])
    if kernel.ndim != 2:
        raise ValueError(f"{where}: expected a 2D (in, out) Dense kernel, "
                         f"got shape {kernel.shape}")
    out = {"weight": torch.from_numpy(np.array(kernel.T, order="C"))}
    if bias:
        b = _f32(sub["bias"])
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


def dkl_fe_from_jax(fe_params: Mapping[str, Any], meta: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """The port's DKL feature extractor ``state_dict`` from a JAX
    ``dklGPTrainer``'s ``fe_params`` and its ``dimdict`` (``input_dim``,
    ``embedim``): an fc extractor's ``Dense_i`` kernel (in, out) becomes
    ``layers.i``'s weight (out, in); a tree with a leading member axis
    (kernels (b, in, out), independent outputs and ensembles) becomes a
    ``StackedFeatureExtractor``'s ``kernels.i`` and ``biases.i`` as they
    are. Raises ``ValueError`` on a tree that does not fit the dimdict."""
    n = len(fe_params)
    _expect(fe_params, {f"Dense_{i}" for i in range(n)}, "feature extractor")
    kernels = [_f32(fe_params[f"Dense_{i}"]["kernel"])
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
            b = _f32(fe_params[f"Dense_{i}"]["bias"])
            if k.ndim != 3 or b.shape != (k.shape[0], k.shape[2]):
                raise ValueError(f"{where}: kernel {k.shape} and bias "
                                 f"{b.shape} are not member-stacked")
            fe[f"kernels.{i}"] = torch.from_numpy(np.array(k))
            fe[f"biases.{i}"] = torch.from_numpy(np.array(b))
        else:
            _put(fe, f"layers.{i}", _dense(fe_params[f"Dense_{i}"], where))
    return fe


def dkl_from_jax(fe_params: Mapping[str, Any], gp_params: Mapping[str, Any],
                 meta: Mapping[str, Any]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(extractor ``state_dict``, GP params) of the port's DKL models from a
    JAX ``dklGPTrainer``'s ``fe_params`` and ``gp_params`` and its
    ``dimdict``: :func:`dkl_fe_from_jax`, and the raw GP parameters copied
    as they are. Raises ``ValueError`` on a tree that does not fit."""
    fe = dkl_fe_from_jax(fe_params, meta)
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
                     sub_p, sub_s, len(sub_p["scale"]),
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


# ------------------------------------------------------------------
# the original atomai's (PyTorch) .tar checkpoints
# ------------------------------------------------------------------
# The port's own copy of the JAX package's maps (`atomai_tpu/models/
# conversion.py:25-52, 267-366, 434-450, 546-612`): each entry pairs a
# prefix of the reference's state_dict with a flax module path; the
# reference's layers are read in state_dict order per kind (convs and
# linears; BatchNorms) and built into the JAX package's variable tree,
# which the bridges above then turn into the port's state_dicts.

_UNET_PLAIN = [("c1", "ConvBlock_0"), ("c2", "ConvBlock_1"),
               ("c3", "ConvBlock_2"), ("bn", "ConvBlock_3"),
               ("upsample_block1", "UpsampleBlock_0"), ("c4", "ConvBlock_4"),
               ("upsample_block2", "UpsampleBlock_1"), ("c5", "ConvBlock_5"),
               ("upsample_block3", "UpsampleBlock_2"), ("c6", "ConvBlock_6"),
               ("px", "Conv_0")]
_UNET_DIL = [("c1", "ConvBlock_0"), ("c2", "ConvBlock_1"),
             ("c3", "ConvBlock_2"), ("bn", "DilatedBlock_0"),
             ("upsample_block1", "UpsampleBlock_0"), ("c4", "ConvBlock_3"),
             ("upsample_block2", "UpsampleBlock_1"), ("c5", "ConvBlock_4"),
             ("upsample_block3", "UpsampleBlock_2"), ("c6", "ConvBlock_5"),
             ("px", "Conv_0")]
_DILNET = [("c1", "ConvBlock_0"), ("at1", "DilatedBlock_0"),
           ("at2", "DilatedBlock_1"), ("up1", "UpsampleBlock_0"),
           ("c2", "ConvBlock_1"), ("px", "Conv_0")]
_SEGRESNET = [("c1", "ConvBlock_0"), ("c2", "ResModule_0"),
              ("bn", "ResModule_1"), ("upsample_block1", "UpsampleBlock_0"),
              ("c3", "ResModule_2"), ("upsample_block2", "UpsampleBlock_1"),
              ("c4", "ConvBlock_1"), ("px", "Conv_0")]


def _fcnn_mapping(model: str, with_dilation: bool):
    if model == "Unet":
        m = _UNET_DIL if with_dilation else _UNET_PLAIN
    elif model == "dilnet":
        m = _DILNET
    elif model == "SegResNet":
        m = _SEGRESNET
    else:
        raise NotImplementedError(
            f"Torch checkpoint conversion not implemented for '{model}'")
    return [(t, (f,)) for t, f in m]


def _collect_layers(sd: Mapping[str, Any], prefix: str):
    """([(weight, bias)] of the convs and linears, [BatchNorm dict]) under
    ``prefix`` in the reference's state_dict order."""
    layers = []
    for k in sd:
        if k == prefix or k.startswith(prefix + "."):
            lk = k.rsplit(".", 1)[0]
            if lk not in layers:
                layers.append(lk)
    convs, bns = [], []
    for lk in layers:
        w = sd.get(lk + ".weight")
        if w is None:
            continue
        w = _f32(w)
        b = sd.get(lk + ".bias")
        if w.ndim == 1 and lk + ".running_mean" in sd:
            bns.append({"scale": w, "bias": _f32(b),
                        "mean": _f32(sd[lk + ".running_mean"]),
                        "var": _f32(sd[lk + ".running_var"])})
        elif w.ndim >= 2:
            convs.append((w, None if b is None else _f32(b)))
    return convs, bns


def _to_flax(w: np.ndarray, b: Optional[np.ndarray]) -> Dict[str, Any]:
    """A torch conv (OIHW, OIL) or linear (out, in) as a flax leaf."""
    kernel = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}[w.ndim]
    out = {"kernel": np.ascontiguousarray(w.transpose(kernel))}
    if b is not None:
        out["bias"] = b
    return out


def _relayout_linear(convs, layout):
    """A torch Linear's features across the NCHW -> NHWC flatten: "in"
    reorders the input columns (a Linear reading a flattened conv map),
    "out" the output rows and bias (a Linear whose output is reshaped to
    (C, *spatial) in torch, (*spatial, C) in flax)."""
    mode, c, sp = layout
    sp = tuple(sp)
    out = []
    for w, b in convs:
        if mode == "in":
            wt = np.moveaxis(w.reshape((w.shape[0], c) + sp), 1, -1)
            out.append((wt.reshape(w.shape[0], -1), b))
        else:
            wt = np.moveaxis(w.reshape((c,) + sp + (w.shape[1],)), 0, -2)
            bt = None if b is None else \
                np.moveaxis(b.reshape((c,) + sp), 0, -1).ravel()
            out.append((wt.reshape(-1, w.shape[1]), bt))
    return out


def _flax_module(name: str, convs, bns, where: str):
    """(params, batch_stats) of the flax module ``name`` from its ordered
    layers: a Conv/Dense leaf, an UpsampleBlock (``Conv_0``), a ConvBlock
    or DilatedBlock (``Conv_i``, ``BatchNorm_i``), or a ResModule
    (``ResBlock_j`` of three convs and zero or two BatchNorms)."""
    kind = name.rsplit("_", 1)[0]
    if kind in ("Conv", "Dense"):
        if len(convs) != 1 or bns:
            raise ValueError(f"{where}: expected one layer, got "
                             f"{len(convs)} and {len(bns)} BatchNorms")
        return _to_flax(*convs[0]), {}
    if kind == "UpsampleBlock":
        return {"Conv_0": _to_flax(*convs[0])}, {}
    if kind == "ResModule":
        per = 2 if bns else 0
        if len(convs) % 3 or len(bns) != per * len(convs) // 3:
            raise ValueError(f"{where}: {len(convs)} convs and {len(bns)} "
                             "BatchNorms are not ResBlocks")
        p, s = {}, {}
        for j in range(len(convs) // 3):
            bp, bs = _conv_bn(convs[3 * j:3 * j + 3],
                              bns[per * j:per * j + per])
            p[f"ResBlock_{j}"] = bp
            if bs:
                s[f"ResBlock_{j}"] = bs
        return p, s
    if bns and len(bns) != len(convs):
        raise ValueError(f"{where}: {len(convs)} convs and {len(bns)} "
                         "BatchNorms")
    return _conv_bn(convs, bns)


def _conv_bn(convs, bns):
    """``Conv_i`` and ``BatchNorm_i`` of ordered layers."""
    p = {f"Conv_{i}": _to_flax(w, b) for i, (w, b) in enumerate(convs)}
    s = {}
    for i, bn in enumerate(bns):
        p[f"BatchNorm_{i}"] = {"scale": bn["scale"], "bias": bn["bias"]}
        s[f"BatchNorm_{i}"] = {"mean": bn["mean"], "var": bn["var"]}
    return p, s


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def reference_to_jax(sd: Mapping[str, Any], mapping) -> Tuple[Dict, Dict]:
    """The JAX package's (params, batch_stats) of a reference state_dict,
    from ``mapping`` entries ``(torch prefix, flax path[, layout])``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for entry in mapping:
        prefix, path = entry[0], tuple(entry[1])
        convs, bns = _collect_layers(sd, prefix)
        if len(entry) > 2:
            convs = _relayout_linear(convs, entry[2])
        if not convs and not bns:
            raise ValueError(f"no torch tensors under prefix '{prefix}'")
        p, s = _flax_module(path[-1], convs, bns, prefix)
        _set(params, path, p)
        if s:
            _set(stats, path, s)
    return params, stats


def _imspec_mapping(meta: Mapping[str, Any]):
    """SignalED (JAX `conversion.py:267-290`)."""
    in_dim, out_dim = tuple(meta["in_dim"]), tuple(meta["out_dim"])
    down = meta.get("encoder_downsampling", 0)
    up = meta.get("decoder_upsampling", False)
    enc_sp = tuple(s // down for s in in_dim) if down else in_dim
    dec_sp = tuple(s // 4 for s in out_dim) if up else out_dim
    m = [("encoder.conv", ("encoder", "ConvBlock_0")),
         ("encoder.fc", ("encoder", "Dense_0"),
          ("in", meta.get("nbfilters_encoder", 64), enc_sp)),
         ("decoder.fc", ("decoder", "Dense_0"),
          ("out", meta.get("nbfilters_decoder", 64), dec_sp))]
    if up:
        m += [("decoder.deconv1", ("decoder", "ConvBlock_0")),
              ("decoder.deconv2", ("decoder", "ConvBlock_1")),
              ("decoder.conv", ("decoder", "ConvBlock_2"))]
    else:
        m += [("decoder.conv", ("decoder", "ConvBlock_0"))]
    return m + [("decoder.dilblock", ("decoder", "DilatedBlock_0")),
                ("decoder.out", ("decoder", "Conv_0"))]


def _vae_encoder_mapping(meta: Mapping[str, Any]):
    """(j)EncoderNet, fc or conv (JAX `conversion.py:320-343`)."""
    n_disc = len(meta.get("discrete_dim") or ())
    heads = ["fc11", "fc12"] + [f"fc13.{k}" for k in range(n_disc)]
    if meta.get("conv_encoder", False):
        lay = ("in", meta.get("numhidden_encoder", 128),
               tuple(meta["in_dim"][:2]))
        return [("conv", ("ConvBlock_0",))] + [
            (h, (f"Dense_{i}",), lay) for i, h in enumerate(heads)]
    n = meta.get("numlayers_encoder", 2)
    return [(f"dense.{2 * i}", (f"Dense_{i}",)) for i in range(n)] + [
        (h, (f"Dense_{n + i}",)) for i, h in enumerate(heads)]


def _vae_decoder_mapping(meta: Mapping[str, Any]):
    """fc, conv or rotational decoder (JAX `conversion.py:346-366`)."""
    n = meta.get("numlayers_decoder", 2)
    out_dim = tuple(meta["in_dim"])
    if meta.get("coord", 0):
        return [("coord_latent.fc_coord", ("coord_latent_0", "Dense_0")),
                ("coord_latent.fc_latent", ("coord_latent_0", "Dense_1"))] + [
            (f"fc_decoder.{2 * i}", (f"Dense_{i}",)) for i in range(n)] + [
            ("out", (f"Dense_{n}",))]
    if meta.get("conv_decoder", False):
        return [("fc_linear", ("Dense_0",),
                 ("out", meta.get("numhidden_decoder", 128), out_dim[:2])),
                ("decoder", ("ConvBlock_0",)), ("conv_1x1", ("Conv_0",))]
    c = out_dim[-1] if len(out_dim) > 2 else 1
    return [(f"decoder.{2 * i}", (f"Dense_{i}",)) for i in range(n)] + [
        ("out", (f"Dense_{n}",), ("out", c, out_dim[:2]))]


def _denoiser_mapping(meta: Mapping[str, Any]):
    """Sequential(encoder, decoder) (JAX `conversion.py:434-450`)."""
    n_enc = len(meta.get("encoder_filters", (8, 16, 32, 64)))
    n_dec = len(meta.get("decoder_filters", (64, 32, 16, 8)))
    m = [(f"0.{2 * i}", (f"ConvBlock_{i}",)) for i in range(n_enc)]
    for i in range(n_dec):
        if i > 0:
            m.append((f"1.{2 * i - 1}", (f"UpsampleBlock_{i - 1}",)))
        m.append((f"1.{2 * i}", (f"ConvBlock_{n_enc + i}",)))
    return m + [(f"1.{2 * (n_dec - 1) + 1}", ("Conv_0",))]


def _reference_backbone_key(backbone: str, key: str) -> str:
    """The reference's ``backbone.backbone_layers`` key of a torchvision
    layer: its ResNet50 re-wraps the children in one Sequential
    (0 conv1, 1 bn1, 4-7 layer1-4); VGG16 and MobileNetV2 keep the
    ``features`` indices."""
    if backbone == "resnet":
        head, _, rest = key.partition(".")
        key = {"conv1": "0", "bn1": "1"}.get(head) or \
            f"{3 + int(head[len('layer'):])}.{rest}"
    return "backbone.backbone_layers." + key


def _reference_reg_cls(sd: Mapping[str, Any], meta: Mapping[str, Any]):
    """(params, batch_stats) of a reference Regressor or Classifier
    (JAX `conversion.py:608-679`)."""
    backbone = meta.get("backbone", "mobilenet")
    if backbone not in BACKBONE_NAMES:
        raise ValueError(f"Unknown backbone_type '{backbone}'")
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, path, kind in BACKBONE_NAMES[backbone]():
        full = _reference_backbone_key(backbone, key)
        path = ("ConvBackbone_0", "features") + tuple(path)
        if kind == "conv":
            b = sd.get(full + ".bias")
            _set(params, path, _to_flax(_f32(sd[full + ".weight"]),
                                        None if b is None else _f32(b)))
        else:
            _set(params, path, {"scale": _f32(sd[full + ".weight"]),
                                "bias": _f32(sd[full + ".bias"])})
            _set(stats, path, {"mean": _f32(sd[full + ".running_mean"]),
                               "var": _f32(sd[full + ".running_var"])})
    head = "output_layer" if meta["model_type"] == "reg" \
        else "output_layer.0"
    params["Dense_0"] = _to_flax(_f32(sd[head + ".weight"]),
                                 _f32(sd[head + ".bias"]))
    return params, stats


def _state_dict(sd) -> Dict[str, Any]:
    return dict(sd.items()) if hasattr(sd, "items") else sd


def _reference_model(loaded: Mapping[str, Any], device: str):
    """The port's model of a reference metadict, weights loaded."""
    from . import loaders
    meta = {k: v for k, v in loaded.items()
            if k not in ("weights", "encoder", "decoder", "optimizer")}
    kind = meta.get("model_type")
    if kind == "seg":
        meta.setdefault("model", "Unet")
        model = loaders.build_model(meta, device)
        model.load_jax_variables(*reference_to_jax(
            _state_dict(loaded["weights"]),
            _fcnn_mapping(meta["model"], meta.get("with_dilation", False))))
    elif kind == "imspec":
        model = loaders.build_model(meta, device)
        model.load_jax_variables(*reference_to_jax(
            _state_dict(loaded["weights"]),
            _imspec_mapping(model.meta_state_dict)))
    elif kind == "denoising_autoencoder":
        model = loaders.build_model(meta, device)
        model.load_jax_variables(*reference_to_jax(
            _state_dict(loaded["weights"]), _denoiser_mapping(meta)))
    elif kind in ("reg", "cls"):
        model = loaders.build_model(meta, device)
        model.load_jax_variables(*_reference_reg_cls(
            _state_dict(loaded["weights"]), meta))
    elif kind == "vae":
        coord, disc = meta.get("coord", 0), meta.get("discrete_dim")
        meta["vae_type"] = ("jr" if coord and disc else "r" if coord
                            else "j" if disc else "") + "VAE"
        model = loaders.build_model(meta, device)
        enc, _ = reference_to_jax(_state_dict(loaded["encoder"]),
                                  _vae_encoder_mapping(model.metadict))
        dec, _ = reference_to_jax(_state_dict(loaded["decoder"]),
                                  _vae_decoder_mapping(model.metadict))
        model.load_jax_params({"encoder": enc, "decoder": dec})
        return model
    else:
        raise NotImplementedError(
            f"Torch checkpoint conversion for model_type={kind} is not "
            "implemented (supported: 'seg', 'imspec', 'vae', 'reg', 'cls', "
            "'denoising_autoencoder')")
    model.meta_state_dict = {**model.meta_state_dict, **meta}
    return model


def load_torch_checkpoint(filepath: str, device: str = "cuda"):
    """The port's model, on ``device`` (the card by default), of a
    checkpoint of the original atomai (a ``.tar`` metadict: constructor
    arguments and a ``state_dict``), for every model type of its
    ``load_model`` (JAX `conversion.py:705-734`): "seg" (Unet, dilnet,
    SegResNet), "imspec", "vae" (rVAE, jVAE, jrVAE by the stored
    ``coord`` and ``discrete_dim``), "reg" and "cls" (the torchvision
    backbones) and "denoising_autoencoder".

    The file is read with ``torch.load(..., weights_only=False)``, as the
    JAX package reads it: the reference pickles its metadict, so only load
    files you trust."""
    loaded = torch.load(filepath, map_location="cpu", weights_only=False)
    return _reference_model(loaded, device)


def load_torch_ensemble(filepath: str, device: str = "cuda"):
    """(the Segmentor with the members' mean parameters, {member:
    state_dict}) of the original atomai's ``*_ensemble_metadict.tar``
    (JAX `conversion.py:737-770`), on ``device``. Each member keeps its own
    BatchNorm statistics; the averaged model takes the last member's, as
    in the JAX package. Read with ``torch.load(..., weights_only=False)``
    (trusted files only)."""
    loaded = torch.load(filepath, map_location="cpu", weights_only=False)
    if loaded.get("model_type") != "seg":
        raise NotImplementedError(
            "Ensemble conversion currently supports segmentation "
            f"ensembles only (got model_type={loaded.get('model_type')})")
    members = loaded["weights"]
    if not isinstance(members, dict):
        raise ValueError("expected ensemble weights as {index: state_dict}")
    ensemble = {}
    for idx in sorted(members):
        model = _reference_model({**loaded, "weights": members[idx]}, device)
        ensemble[int(idx)] = {k: v.detach().clone() for k, v in
                              model.net.state_dict().items()}
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            p.copy_(torch.stack([m[name] for m in ensemble.values()]
                                ).mean(0))
    return model, ensemble


PRETRAINED = {
    "BFO": ("https://github.com/ziatdinovmax/atomai/blob/master/"
            "pretrained/bfo.tar?raw=true", "./bfo.tar"),
    "G_MD": ("https://github.com/ziatdinovmax/atomai/blob/master/"
             "pretrained/G_MD.tar?raw=true", "./G_MD.tar"),
}


def load_pretrained_model(model_name: str, device: str = "cuda"):
    """Downloads a published pretrained model of the original atomai
    ('G_MD' or 'BFO') into the working directory and loads it with
    :func:`load_torch_checkpoint` (JAX `conversion.py:773-787`)."""
    import urllib.request
    if model_name not in PRETRAINED:
        raise ValueError("Available pretrained models: 'G_MD', 'BFO'")
    url, path = PRETRAINED[model_name]
    urllib.request.urlretrieve(url, path)
    return load_torch_checkpoint(path, device)
