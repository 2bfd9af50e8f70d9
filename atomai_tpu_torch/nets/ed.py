"""Encoders and decoders of the im2spec nets and of the VAE family.

Counterpart of `atomai_tpu/nets/ed.py:36-501`:
- SignalEncoder / SignalDecoder / SignalED, the image <-> spectrum
  translator, and init_imspec_model, its factory with its metadict;
- fcEncoderNet / convEncoderNet -> (z_mu, z_logstd), and the joint
  encoders jfcEncoderNet / jconvEncoderNet, which add one softmax head per
  discrete latent -> (z_mu, z_logstd, alpha_1, ...);
- fcDecoderNet and convDecoderNet (the plain VAE's) and rDecoderNet with
  its coord_latent (the rVAE's spatial decoder, after arXiv:1909.11663: a
  per-pixel MLP over fc(coord) + fc(z) broadcast over the pixels);
- init_VAE_nets, the factory with its metadict.

Inputs and outputs keep the JAX package's channel-last layout: images
(N, H, W) or (N, H, W, C). Submodules carry original atomai's names
(``dense.{2i}``, ``fc11``, ``fc12``, ``fc13.{k}``, ``fc_linear``,
``coord_latent.fc_coord``, ``coord_latent.fc_latent``,
``fc_decoder.{2i}``, ``out``), the names
`atomai_tpu/models/conversion.py:320-366` maps. Hidden layers follow the
precision scope the caller runs under (bf16 under the card's mixed
policy); the heads run in float32 (:func:`head_f32`), as the JAX package's
Dense heads without ``dtype`` do.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

import torch.nn.functional as F

from ..core.dtypes import head_f32
from ..ops.spatial_mlp import mlp_shapes_supported, spatial_mlp
from .blocks import ConvBlock, DilatedBlock
from .remat import Rematerializable, checkpointed


def _signal_dim(signal_dim) -> Tuple[int, ...]:
    sdim = (signal_dim,) if isinstance(signal_dim, int) else tuple(signal_dim)
    if not 0 < len(sdim) < 3:
        raise AssertionError("signal dimensionality must be 1D or 2D")
    return sdim


class SignalEncoder(nn.Module):
    """Encodes a 1D or 2D signal into a latent vector (`ed.py:36-62`):
    optional average pooling by ``downsampling``, a ConvBlock
    (LeakyReLU 0.1), and a float32 Linear head.

    Takes (N, *signal_dim) or channel-last (N, *signal_dim, C). The head
    reads the conv map flattened channel-last, the JAX package's order, so
    its weights carry over as they are.
    """

    def __init__(self, signal_dim, z_dim: int, nb_layers: int,
                 nb_filters: int, batch_norm: bool = True,
                 downsampling: int = 0, input_channels: int = 1):
        super().__init__()
        self.signal_dim = _signal_dim(signal_dim)
        self.ndim = len(self.signal_dim)
        self.downsampling = downsampling
        self.conv = ConvBlock(self.ndim, nb_layers, input_channels,
                              nb_filters, lrelu_a=0.1, batch_norm=batch_norm)
        d = downsampling or 1
        n_flat = nb_filters * int(np.prod([s // d for s in self.signal_dim]))
        self.fc = nn.Linear(n_flat, z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None] if x.ndim == self.ndim + 1 else x.movedim(-1, 1)
        if self.downsampling:
            pool = F.avg_pool1d if self.ndim == 1 else F.avg_pool2d
            x = pool(x, self.downsampling)
        x = self.conv(x).movedim(1, -1)
        return head_f32(self.fc, x.reshape(x.shape[0], -1))


class SignalDecoder(nn.Module):
    """Decodes a latent vector into a 1D or 2D signal (`ed.py:65-103`): a
    Linear layer to ``nb_filters`` channels on the signal grid (a quarter
    of it with ``upsampling``, then two ConvBlock + nearest 2x upsampling
    steps), a DilatedBlock of dilations 1..nb_layers, a ConvBlock to one
    channel and a float32 1x1 conv head. Returns (N, *signal_dim).

    The Linear layer's outputs are ordered channel-last (the JAX package's
    reshape to (-1, *grid, nb_filters)), then moved to channel-first.
    """

    def __init__(self, signal_dim, z_dim: int, nb_layers: int,
                 nb_filters: int, batch_norm: bool = True,
                 upsampling: bool = False):
        super().__init__()
        self.signal_dim = _signal_dim(signal_dim)
        ndim = len(self.signal_dim)
        self.nb_filters = nb_filters
        self.upsampling = upsampling
        self.work_dim = tuple(s // 4 for s in self.signal_dim) \
            if upsampling else self.signal_dim
        self.fc = nn.Linear(z_dim, nb_filters * int(np.prod(self.work_dim)))
        if upsampling:
            self.deconv1 = ConvBlock(ndim, 1, nb_filters, nb_filters,
                                     lrelu_a=0.1, batch_norm=batch_norm)
            self.deconv2 = ConvBlock(ndim, 1, nb_filters, nb_filters,
                                     lrelu_a=0.1, batch_norm=batch_norm)
        dil = list(range(1, nb_layers + 1))
        self.dilblock = DilatedBlock(ndim, nb_filters, nb_filters, dil, dil,
                                     lrelu_a=0.1, batch_norm=batch_norm)
        self.conv = ConvBlock(ndim, 1, nb_filters, 1, lrelu_a=0.1,
                              batch_norm=batch_norm)
        self.out = (nn.Conv1d if ndim == 1 else nn.Conv2d)(1, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.fc(z).reshape((-1,) + self.work_dim + (self.nb_filters,))
        x = x.movedim(-1, 1)
        if self.upsampling:
            for block in (self.deconv1, self.deconv2):
                # jax.image.resize "nearest" at an exact factor of 2
                x = F.interpolate(block(x), scale_factor=2, mode="nearest")
        x = self.conv(self.dilblock(x))
        return head_f32(self.out, x)[:, 0]



class SignalED(nn.Module):
    """Image <-> spectrum translator (`ed.py:106-136`): a SignalEncoder to
    ``latent_dim`` latents, then a SignalDecoder."""

    def __init__(self, feature_dim, target_dim, latent_dim: int,
                 nblayers_encoder: int = 2, nblayers_decoder: int = 2,
                 nbfilters_encoder: int = 64, nbfilters_decoder: int = 2,
                 batch_norm: bool = True, encoder_downsampling: int = 0,
                 decoder_upsampling: bool = False):
        super().__init__()
        self.encoder = SignalEncoder(feature_dim, latent_dim,
                                     nblayers_encoder, nbfilters_encoder,
                                     batch_norm, encoder_downsampling)
        self.decoder = SignalDecoder(target_dim, latent_dim,
                                     nblayers_decoder, nbfilters_decoder,
                                     batch_norm, decoder_upsampling)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        return self.encoder(features)

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return self.decoder(latent)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def init_imspec_model(in_dim: Tuple[int, ...], out_dim: Tuple[int, ...],
                      latent_dim: int, **kwargs: Any
                      ) -> Tuple[nn.Module, Dict[str, Any]]:
    """The ImSpec net and its metadict (`ed.py:412-440`: the same defaults
    and keys)."""
    nblayers_encoder = kwargs.get("nblayers_encoder", 3)
    nblayers_decoder = kwargs.get("nblayers_decoder", 4)
    nbfilters_encoder = kwargs.get("nbfilters_encoder", 64)
    nbfilters_decoder = kwargs.get("nbfilters_decoder", 64)
    batch_norm = kwargs.get("batch_norm", True)
    encoder_downsampling = kwargs.get("encoder_downsampling", 0)
    decoder_upsampling = kwargs.get("decoder_upsampling", False)
    net = SignalED(tuple(in_dim), tuple(out_dim), latent_dim,
                   nblayers_encoder, nblayers_decoder, nbfilters_encoder,
                   nbfilters_decoder, batch_norm, encoder_downsampling,
                   decoder_upsampling)
    meta_state_dict = {
        "model_type": "imspec",
        "in_dim": tuple(in_dim),
        "out_dim": tuple(out_dim),
        "latent_dim": latent_dim,
        "nblayers_encoder": nblayers_encoder,
        "nblayers_decoder": nblayers_decoder,
        "nbfilters_encoder": nbfilters_encoder,
        "nbfilters_decoder": nbfilters_decoder,
        "batchnorm": batch_norm,
        "encoder_downsampling": encoder_downsampling,
        "decoder_upsampling": decoder_upsampling,
    }
    return net, meta_state_dict


def _tanh_stack(in_features: int, hidden_dim: int, num_layers: int
                ) -> nn.Sequential:
    """[Linear, Tanh] * num_layers: the Linear layers are ``{2i}``."""
    layers = []
    for i in range(num_layers):
        layers += [nn.Linear(in_features if i == 0 else hidden_dim,
                             hidden_dim), nn.Tanh()]
    return nn.Sequential(*layers)


def _encoded(encoder: nn.Module, x: torch.Tensor
             ) -> Tuple[torch.Tensor, ...]:
    """(z_mu, z_logstd) from the float32 heads, then the softmax of each
    discrete head (a joint encoder's ``fc13``)."""
    z_mu = head_f32(encoder.fc11, x)
    z_logstd = head_f32(encoder.fc12, x)
    if encoder.softplus_out:
        z_logstd = F.softplus(z_logstd)
    return (z_mu, z_logstd) + tuple(torch.softmax(head_f32(fc, x), 1)
                                    for fc in getattr(encoder, "fc13", ()))


class fcEncoderNet(Rematerializable, nn.Module):
    """MLP encoder -> (z_mu, z_logstd) (`ed.py:139-162`)."""

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 num_layers: int = 2, hidden_dim: int = 32,
                 softplus_out: bool = False):
        super().__init__()
        n_in = int(np.prod(in_dim))
        self.dense = _tanh_stack(n_in, hidden_dim, num_layers)
        head_in = hidden_dim if num_layers else n_in
        self.fc11 = nn.Linear(head_in, latent_dim)
        self.fc12 = nn.Linear(head_in, latent_dim)
        self.softplus_out = softplus_out

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return _encoded(self, self.dense(x.reshape(x.shape[0], -1)))


class jfcEncoderNet(fcEncoderNet):
    """MLP encoder with one softmax head per discrete latent
    (`ed.py:189-214`) -> (z_mu, z_logstd, alpha_1, ...)."""

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 discrete_dim=(1,), num_layers: int = 2,
                 hidden_dim: int = 32, softplus_out: bool = False):
        super().__init__(in_dim, latent_dim, num_layers, hidden_dim,
                         softplus_out)
        self.fc13 = nn.ModuleList(nn.Linear(self.fc11.in_features, d)
                                  for d in discrete_dim)


class convEncoderNet(Rematerializable, nn.Module):
    """Conv encoder -> (z_mu, z_logstd) (`ed.py:165-186`): images
    (H, W[, C]) through a 2D ConvBlock, spectra (L,) through a 1D one.

    The heads read the conv map flattened channel-first (NCHW / NCL,
    original atomai's order); the JAX package flattens channel-last, and
    ``vae_from_jax`` reorders the heads' weights accordingly.
    """

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 num_layers: int = 2, hidden_dim: int = 32,
                 softplus_out: bool = False, lrelu_a: float = 0.1):
        super().__init__()
        self.ndim = 2 if len(in_dim) > 1 else 1
        c = in_dim[2] if len(in_dim) > 2 else 1
        self.conv = ConvBlock(self.ndim, num_layers, c, hidden_dim,
                              lrelu_a=lrelu_a)
        n_flat = hidden_dim * int(np.prod(in_dim[:self.ndim]))
        self.fc11 = nn.Linear(n_flat, latent_dim)
        self.fc12 = nn.Linear(n_flat, latent_dim)
        self.softplus_out = softplus_out

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x[:, None] if x.ndim == self.ndim + 1 else x.movedim(-1, 1)
        return _encoded(self, self.conv(x).reshape(x.shape[0], -1))


class jconvEncoderNet(convEncoderNet):
    """Conv encoder with one softmax head per discrete latent
    (`ed.py:217-245`) -> (z_mu, z_logstd, alpha_1, ...)."""

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 discrete_dim=(1,), num_layers: int = 2,
                 hidden_dim: int = 32, softplus_out: bool = False,
                 lrelu_a: float = 0.1):
        super().__init__(in_dim, latent_dim, num_layers, hidden_dim,
                         softplus_out, lrelu_a)
        self.fc13 = nn.ModuleList(nn.Linear(self.fc11.in_features, d)
                                  for d in discrete_dim)


def _channel_last(h: torch.Tensor, out_dim: Tuple[int, ...]) -> torch.Tensor:
    """(N, n_features) -> (N, H, W) for one channel, (N, H, W, C)
    otherwise, (N, L) for spectra (`ed.py:248-276`)."""
    c = out_dim[-1] if len(out_dim) > 2 else 1
    if len(out_dim) > 1:
        h = h.reshape((-1,) + tuple(out_dim[:2]) + (c,))
    else:
        h = h.reshape(-1, out_dim[0], c)
    return h[..., 0] if c == 1 else h


class fcDecoderNet(Rematerializable, nn.Module):
    """MLP decoder (`ed.py:256-276`). The output features are ordered
    (h, w, c), the JAX package's order."""

    def __init__(self, out_dim: Tuple[int, ...], latent_dim: int,
                 num_layers: int = 2, hidden_dim: int = 32):
        super().__init__()
        self.out_dim = tuple(out_dim)
        self.decoder = _tanh_stack(latent_dim, hidden_dim, num_layers)
        self.out = nn.Linear(hidden_dim if num_layers else latent_dim,
                             int(np.prod(out_dim)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return _channel_last(head_f32(self.out, self.decoder(z)),
                             self.out_dim)


class _LecunNormalInit:
    """flax's default init for a conv (lecun-normal kernel: a normal of
    std sqrt(1/fan_in) truncated at two of its own std, rescaled to keep
    that variance; zero bias), which :func:`init_weights_` draws in place
    of the U(+-1/sqrt(fan_in)) of the other layers."""

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        fan_in = self.in_channels * int(np.prod(self.kernel_size))
        std = (1.0 / fan_in) ** 0.5 / .87962566103423978
        w = torch.empty(self.weight.shape, device=generator.device)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.weight.copy_(w)
        self.bias.zero_()


class _LecunConv1d(_LecunNormalInit, nn.Conv1d):
    pass


class _LecunConv2d(_LecunNormalInit, nn.Conv2d):
    pass


class convDecoderNet(Rematerializable, nn.Module):
    """Conv decoder (`ed.py:279-300`): a bias-free Linear layer to
    ``hidden_dim`` channels on the output grid, a ConvBlock (LeakyReLU
    0.1, no BatchNorm) and a float32 1x1 conv to the output channels.
    1D (out_dim (L,)) or 2D ((H, W[, C])).

    The Linear layer's outputs are ordered channel-last (the JAX package's
    reshape to (-1, *grid, hidden_dim)), then moved to channel-first. The
    1x1 conv keeps flax's default init (the JAX conv carries no
    ``init_kwargs``), see :class:`_LecunNormalInit`.
    """

    def __init__(self, out_dim: Tuple[int, ...], latent_dim: int,
                 num_layers: int = 2, hidden_dim: int = 32,
                 lrelu_a: float = 0.1):
        super().__init__()
        self.out_dim = tuple(out_dim)
        ndim = 2 if len(out_dim) > 1 else 1
        c = out_dim[-1] if len(out_dim) > 2 else 1
        self.spatial = self.out_dim[:ndim]
        self.hidden_dim = hidden_dim
        self.fc_linear = nn.Linear(
            latent_dim, hidden_dim * int(np.prod(self.spatial)), bias=False)
        self.decoder = ConvBlock(ndim, num_layers, hidden_dim, hidden_dim,
                                 lrelu_a=lrelu_a)
        self.out = (_LecunConv1d if ndim == 1 else _LecunConv2d)(
            hidden_dim, c, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.fc_linear(z).reshape((-1,) + self.spatial
                                      + (self.hidden_dim,))
        h = head_f32(self.out, self.decoder(h.movedim(-1, 1)))
        h = h.movedim(1, -1)
        return h[..., 0] if h.shape[-1] == 1 else h


class coord_latent(nn.Module):
    """Spatial part of the rVAE decoder (`ed.py:303-333`):
    h = fc_coord(coords) + fc_latent(z) (no bias) broadcast over the
    pixels, then tanh when ``activation``. (B, n, 2), (B, latent) ->
    (B, n, out_dim)."""

    def __init__(self, latent_dim: int, out_dim: int,
                 activation: bool = False):
        super().__init__()
        self.fc_coord = nn.Linear(2, out_dim)
        self.fc_latent = nn.Linear(latent_dim, out_dim, bias=False)
        self.activation = activation

    def forward(self, x_coord: torch.Tensor, z: torch.Tensor
                ) -> torch.Tensor:
        h = self.fc_coord(x_coord) + self.fc_latent(z)[:, None, :]
        return torch.tanh(h) if self.activation else h


class rDecoderNet(nn.Module):
    """Spatial decoder with optional residual skips (`ed.py:336-409`).

    Routing is by shape, decided before anything runs: without skips, with
    one output channel and a hidden width the kernels take
    (:func:`mlp_shapes_supported`), the whole per-pixel MLP is one
    :func:`spatial_mlp` call (the CUDA kernels for CUDA tensors, the plain
    version for CPU ones); otherwise the layers run one by one, as the JAX
    package's XLA branch does. Both read the same parameters.

    With ``remat`` (set by ``set_remat``), a training call checkpoints the
    layer-by-layer route whole and the plain version of the fused route;
    the fused route's CUDA kernels are left as they are, since their
    backward recomputes the activations on chip already
    (``nets/remat.py``).
    """

    remat = False

    def __init__(self, out_dim: Tuple[int, ...], latent_dim: int,
                 num_layers: int, hidden_dim: int, skip: bool = False):
        super().__init__()
        self.out_dim = tuple(out_dim)
        self.c = 1 if len(out_dim) == 2 else out_dim[-1]
        self.skip = skip
        self.coord_latent = coord_latent(latent_dim, hidden_dim, not skip)
        self.fc_decoder = _tanh_stack(hidden_dim, hidden_dim, num_layers)
        self.out = nn.Linear(hidden_dim, self.c)

    def fused(self) -> bool:
        """Whether :meth:`forward` takes the fused :func:`spatial_mlp`."""
        return (not self.skip and self.c == 1
                and mlp_shapes_supported(self.out.in_features))

    def forward(self, x_coord: torch.Tensor, z: torch.Tensor
                ) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        if remat and not self.fused():
            return checkpointed(self, self._forward, x_coord, z, False)
        return self._forward(x_coord, z, remat)

    def _forward(self, x_coord: torch.Tensor, z: torch.Tensor, remat: bool
                 ) -> torch.Tensor:
        B = x_coord.shape[0]
        reshape_ = (self.out_dim if self.c == 1
                    else self.out_dim[:2] + (self.c,))
        if self.fused():
            cl = self.coord_latent
            hidden = [self.fc_decoder[2 * i]
                      for i in range(len(self.fc_decoder) // 2)]
            H = cl.fc_coord.out_features
            if hidden:
                Ws = torch.stack([m.weight.T for m in hidden])
                bs = torch.stack([m.bias for m in hidden])
            else:
                Ws = cl.fc_coord.weight.new_zeros((0, H, H))
                bs = cl.fc_coord.weight.new_zeros((0, H))
            y = spatial_mlp(
                x_coord.float().transpose(1, 2), head_f32(cl.fc_latent, z),
                cl.fc_coord.weight.T, cl.fc_coord.bias[None], Ws, bs,
                self.out.weight.T, self.out.bias[None], remat=remat)
            return y[:, 0].reshape((B,) + reshape_)
        h = self.coord_latent(x_coord, z)
        if self.skip:
            # the residual is added after every Linear + Tanh pair
            residual = h
            for i in range(len(self.fc_decoder) // 2):
                h = self.fc_decoder[2 * i + 1](self.fc_decoder[2 * i](h))
                h = h + residual
        else:
            h = self.fc_decoder(h)
        return head_f32(self.out, h).reshape((B,) + reshape_)


def init_VAE_nets(in_dim: Tuple[int, ...], latent_dim: int, coord: int = 0,
                  discrete_dim: Optional[List[int]] = None,
                  nb_classes: int = 0, **kwargs: Any
                  ) -> Tuple[nn.Module, nn.Module, Dict[str, Any]]:
    """Encoder, decoder and metadict of the VAE family (`ed.py:443-501`).

    The decoder takes ``latent_dim + sum(discrete_dim) + nb_classes``
    latents, the JAX package's sizing (original atomai drops
    ``nb_classes`` when there are discrete latents, which its own joint
    forward contradicts). With ``discrete_dim`` the encoder is the joint
    one; ``conv_decoder`` applies without ``coord`` only.
    """
    conv_e = kwargs.get("conv_encoder", False)
    conv_d = kwargs.get("conv_decoder", False) if not coord else False
    numlayers_e = kwargs.get("numlayers_encoder", 2)
    numlayers_d = kwargs.get("numlayers_decoder", 2)
    numhidden_e = kwargs.get("numhidden_encoder", 128)
    numhidden_d = kwargs.get("numhidden_decoder", 128)
    skip = kwargs.get("skip", False)
    sigmoid_out = kwargs.get("sigmoid_out", False)
    softplus_out = bool(kwargs.get("softplus_out") or False)
    dec_latent = latent_dim + (sum(discrete_dim) if discrete_dim else 0) \
        + nb_classes

    if coord:
        decoder_net = rDecoderNet(tuple(in_dim), dec_latent, numlayers_d,
                                  numhidden_d, skip)
    else:
        dnet = convDecoderNet if conv_d else fcDecoderNet
        decoder_net = dnet(tuple(in_dim), dec_latent, numlayers_d,
                           numhidden_d)
    if discrete_dim:
        enet = jconvEncoderNet if conv_e else jfcEncoderNet
        encoder_net = enet(tuple(in_dim), latent_dim + coord,
                           tuple(discrete_dim), numlayers_e, numhidden_e,
                           softplus_out=softplus_out)
    else:
        enet = convEncoderNet if conv_e else fcEncoderNet
        encoder_net = enet(tuple(in_dim), latent_dim + coord, numlayers_e,
                           numhidden_e, softplus_out=softplus_out)
    meta_state_dict = {
        "model_type": "vae",
        "in_dim": tuple(in_dim),
        "latent_dim": latent_dim,
        "coord": coord,
        "conv_encoder": conv_e,
        "numlayers_encoder": numlayers_e,
        "numlayers_decoder": numlayers_d,
        "numhidden_encoder": numhidden_e,
        "numhidden_decoder": numhidden_d,
        "skip": skip,
        "nb_classes": nb_classes,
        "discrete_dim": discrete_dim,
        "sigmoid_out": sigmoid_out,
        "softplus_out": softplus_out,
    }
    if not coord:
        meta_state_dict["conv_decoder"] = conv_d
    return encoder_net, decoder_net, meta_state_dict
