"""Model loading from the port's own checkpoints.

Counterpart of `atomai_tpu/models/loaders.py:30-208` for the model types
the port has: ``seg`` (Segmentor, any of its nets), ``imspec`` (ImSpec),
``reg`` (Regressor), ``cls`` (Classifier), ``denoising_autoencoder``
(DenoisingAutoencoder) and ``vae`` (VAE, rVAE, jVAE, jrVAE), and ensembles of
segmentation or ImSpec nets (:func:`load_ensemble`). The model is rebuilt
from the constructor arguments in the file's metadict, then its weights
are loaded. A Segmentor of a user's module ("custom") cannot be rebuilt
from a metadict: load its weights into the module with ``load_weights``.
The JAX package's ``.aoi`` files (msgpack payload) are ROADMAP Queue 1
#20.
"""

from typing import Any, Dict, Mapping, Tuple

import torch.nn as nn

from ..core.checkpoint import load_checkpoint
from ..core.device import resolve_device

_NOT_PORTED = "ROADMAP Queue 1 #20"
_SEG_KEYS = ("batch_norm", "dropout", "with_dilation", "nb_filters",
             "layers", "upsampling")
_DENOISER_KEYS = ("encoder_filters", "decoder_filters", "encoder_layers",
                  "decoder_layers", "use_batch_norm", "upsampling_mode")
_IMSPEC_KEYS = ("nblayers_encoder", "nblayers_decoder", "nbfilters_encoder",
                "nbfilters_decoder", "encoder_downsampling",
                "decoder_upsampling")


def _imspec_kwargs(meta: Mapping[str, Any]) -> Dict[str, Any]:
    kwargs = {k: meta[k] for k in _IMSPEC_KEYS if k in meta}
    if "batchnorm" in meta:
        kwargs["batch_norm"] = meta["batchnorm"]
    return kwargs


def load_model(filepath: str, device: str = "cuda"):
    """A trained model, on ``device`` (the card by default; "cpu" when
    asked for), from a ``.aoit`` file written by ``save_model``."""
    if filepath.endswith(".aoi"):
        raise NotImplementedError(
            f"the port reads its own .aoit files only; reading the JAX "
            f"package's .aoi files is {_NOT_PORTED}")
    meta, arrays = load_checkpoint(filepath)
    model_type = meta.get("model_type")
    if model_type == "seg" and meta.get("model") == "custom":
        raise NotImplementedError(
            "a Segmentor of a custom module cannot be rebuilt from its "
            "metadict: build Segmentor(module) and call load_weights")
    if model_type == "seg":
        from .segmentor import Segmentor
        net_kwargs = {k: meta[k] for k in _SEG_KEYS
                      if meta.get(k) is not None}
        model = Segmentor(meta.get("model", "Unet"),
                          meta.get("nb_classes", 1), device=device,
                          **net_kwargs)
        model.net.load_state_dict(arrays["params"])
        model.meta_state_dict = dict(meta)
        return model
    if model_type == "imspec":
        from .imspec import ImSpec
        model = ImSpec(tuple(meta["in_dim"]), tuple(meta["out_dim"]),
                       meta.get("latent_dim", 2), device=device,
                       **_imspec_kwargs(meta))
        model.net.load_state_dict(arrays["params"])
        model.meta_state_dict = dict(meta)
        return model
    if model_type in ("reg", "cls"):
        from .classifier import Classifier
        from .regressor import Regressor
        model = (Regressor if model_type == "reg" else Classifier)(
            meta.get("backbone", "mobilenet"),
            meta["out_dim" if model_type == "reg" else "nb_classes"],
            input_channels=meta.get("in_channels", 1), device=device)
        model.net.load_state_dict(arrays["params"])
        model.meta_state_dict = dict(meta)
        return model
    if model_type == "denoising_autoencoder":
        from .denoiser import DenoisingAutoencoder
        model = DenoisingAutoencoder(
            **{k: meta[k] for k in _DENOISER_KEYS if k in meta},
            device=device)
        model.net.load_state_dict(arrays["params"])
        model.meta_state_dict = dict(meta)
        return model
    if model_type == "vae":
        from . import dgm
        cls_name = meta.get("vae_type", "VAE")
        if cls_name not in ("VAE", "rVAE", "jVAE", "jrVAE"):
            raise ValueError(f"Unknown VAE type in checkpoint: {cls_name}")
        net_kwargs = {k: meta[k] for k in
                      ("numlayers_encoder", "numlayers_decoder",
                       "numhidden_encoder", "numhidden_decoder",
                       "conv_encoder", "conv_decoder", "skip", "sigmoid_out",
                       "softplus_out")
                      if meta.get(k) is not None}
        if cls_name in ("rVAE", "jrVAE"):
            net_kwargs["translation"] = meta.get("coord", 3) == 3
        if cls_name in ("jVAE", "jrVAE"):
            net_kwargs["discrete_dim"] = list(meta["discrete_dim"])
        model = getattr(dgm, cls_name)(
            tuple(meta["in_dim"]), meta.get("latent_dim", 2),
            nb_classes=meta.get("nb_classes", 0), device=device,
            **net_kwargs)
        model.encoder_net.load_state_dict(arrays["params"]["encoder"])
        model.decoder_net.load_state_dict(arrays["params"]["decoder"])
        # training-progress counters, so that a further fit goes on where
        # this one stopped
        if meta.get("num_iter") is not None:
            model.num_iter = int(meta["num_iter"])
        if meta.get("num_epochs") is not None:
            model.current_epoch = int(meta["num_epochs"])
        model.update_metadict()
        return model
    raise ValueError(f"Unknown model type in checkpoint: {model_type}")


def _load_typed(filepath: str, expected: str, kind: str, device: str):
    model = load_model(filepath, device)
    # the VAE family keeps its metadict as ``metadict``
    meta = getattr(model, "meta_state_dict", None) or model.metadict
    if meta.get("model_type") != expected:
        raise ValueError(f"Checkpoint holds a '{meta.get('model_type')}' "
                         f"model, not a {kind} model")
    return model


def load_seg_model(filepath: str, device: str = "cuda"):
    """A Segmentor from its ``.aoit`` file; other model types raise."""
    return _load_typed(filepath, "seg", "segmentation", device)


def load_imspec_model(filepath: str, device: str = "cuda"):
    """An ImSpec model from its ``.aoit`` file."""
    return _load_typed(filepath, "imspec", "imspec", device)


def load_reg_model(filepath: str, device: str = "cuda"):
    """A Regressor from its ``.aoit`` file."""
    return _load_typed(filepath, "reg", "regression", device)


def load_cls_model(filepath: str, device: str = "cuda"):
    """A Classifier from its ``.aoit`` file."""
    return _load_typed(filepath, "cls", "classification", device)


def load_vae_model(filepath: str, device: str = "cuda"):
    """A VAE, rVAE, jVAE or jrVAE from its ``.aoit`` file."""
    return _load_typed(filepath, "vae", "VAE", device)


def load_denoising_autoencoder(filepath: str, device: str = "cuda"):
    """A DenoisingAutoencoder from its ``.aoit`` file."""
    return _load_typed(filepath, "denoising_autoencoder", "denoiser",
                       device)


def _skeleton(meta: Mapping[str, Any]) -> nn.Module:
    """The net of an ensemble's metadict, built from its dims and widths."""
    from ..nets import init_fcnn_model, init_imspec_model
    model_type = meta.get("model_type")
    if model_type == "seg":
        net, _ = init_fcnn_model(meta.get("model", "Unet"),
                                 meta.get("nb_classes", 1),
                                 **{k: meta[k] for k in _SEG_KEYS
                                    if meta.get(k) is not None})
        return net
    if model_type == "imspec":
        net, _ = init_imspec_model(tuple(meta["in_dim"]),
                                   tuple(meta["out_dim"]),
                                   meta.get("latent_dim", 2),
                                   **_imspec_kwargs(meta))
        return net
    raise ValueError(f"Unsupported ensemble model type: {model_type}")


def load_ensemble(filepath: str, device: str = "cuda"
                  ) -> Tuple[nn.Module, Dict[int, Dict[str, Any]]]:
    """(the net with the ensemble's final weights, {member: state_dict})
    from a ``<name>_ensemble_metadict.aoit`` file written by the ensemble
    trainers, on ``device`` (the card by default; "cpu" when asked for).
    Each member's ``state_dict`` holds its own BatchNorm statistics; the
    net is rebuilt from the metadict's dims and widths."""
    meta, arrays = load_checkpoint(filepath)
    device = resolve_device(device)
    net = _skeleton(meta)
    net.load_state_dict(arrays["params"])
    net.to(device).eval()
    ensemble = {int(k): {n: t.to(device) for n, t in v.items()}
                for k, v in arrays["ensemble"].items()}
    return net, dict(sorted(ensemble.items()))
