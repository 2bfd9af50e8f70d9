"""Model loading from checkpoints: the port's own ``.aoit`` files and the
JAX package's ``.aoi`` files.

Counterpart of `atomai_tpu/models/loaders.py:14-180` for every model
type: ``seg`` (Segmentor, any of its nets), ``imspec`` (ImSpec), ``reg``
(Regressor), ``cls`` (Classifier), ``denoising_autoencoder``
(DenoisingAutoencoder) and ``vae`` (VAE, rVAE, jVAE, jrVAE), and
ensembles of segmentation or ImSpec nets (:func:`load_ensemble`). The
model is rebuilt from the constructor arguments in the file's metadict,
then its weights are loaded: a ``.aoit`` file holds ``state_dict``s, a
``.aoi`` file the JAX package's flax variables, which go through the
weight bridge (``fcnn_from_jax``, ``signal_ed_from_jax``,
``reg_cls_from_jax``, ``denoiser_from_jax``, ``vae_from_jax``,
``ensemble_from_jax``). A source is a path, a ``(meta, arrays)`` pair or
a ``{"meta": ..., "arrays": ...}`` dict, as in the JAX package. A
Segmentor of a user's module ("custom") cannot be rebuilt from a
metadict: load its weights into the module with ``load_weights``.
"""

from typing import Any, Dict, Mapping, Tuple, Union

import torch.nn as nn

from ..core.checkpoint import is_jax_tree, load_checkpoint
from ..core.device import resolve_device
from .conversion import ensemble_from_jax, fcnn_from_jax, signal_ed_from_jax

_SEG_KEYS = ("batch_norm", "dropout", "with_dilation", "nb_filters",
             "layers", "upsampling")
_DENOISER_KEYS = ("encoder_filters", "decoder_filters", "encoder_layers",
                  "decoder_layers", "use_batch_norm", "upsampling_mode")
_IMSPEC_KEYS = ("nblayers_encoder", "nblayers_decoder", "nbfilters_encoder",
                "nbfilters_decoder", "encoder_downsampling",
                "decoder_upsampling")
_VAE_KEYS = ("numlayers_encoder", "numlayers_decoder", "numhidden_encoder",
             "numhidden_decoder", "conv_encoder", "conv_decoder", "skip",
             "sigmoid_out", "softplus_out")

Source = Union[str, Tuple[Dict, Dict], Dict]


def _imspec_kwargs(meta: Mapping[str, Any]) -> Dict[str, Any]:
    kwargs = {k: meta[k] for k in _IMSPEC_KEYS if k in meta}
    if "batchnorm" in meta:
        kwargs["batch_norm"] = meta["batchnorm"]
    return kwargs


def resolve_checkpoint(source: Source) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
    """(meta, arrays) of a checkpoint path, a ``(meta, arrays)`` pair, or a
    dict with ``meta``/``arrays`` keys (JAX `loaders.py:14-28`)."""
    if isinstance(source, str):
        return load_checkpoint(source)
    if isinstance(source, tuple) and len(source) == 2:
        return source
    if isinstance(source, dict) and "meta" in source:
        return source["meta"], source.get("arrays", {})
    raise TypeError(
        "Expected a checkpoint path, a (meta, arrays) pair, or a dict "
        f"with 'meta'/'arrays' keys; got {type(source).__name__}")


def build_model(meta: Mapping[str, Any], device: str):
    """The model a metadict describes, with fresh weights."""
    model_type = meta.get("model_type")
    if model_type == "seg" and meta.get("model") == "custom":
        raise NotImplementedError(
            "a Segmentor of a custom module cannot be rebuilt from its "
            "metadict: build Segmentor(module) and call load_weights")
    if model_type == "seg":
        from .segmentor import Segmentor
        return Segmentor(meta.get("model", "Unet"),
                         meta.get("nb_classes", 1), device=device,
                         **{k: meta[k] for k in _SEG_KEYS
                            if meta.get(k) is not None})
    if model_type == "imspec":
        from .imspec import ImSpec
        return ImSpec(tuple(meta["in_dim"]), tuple(meta["out_dim"]),
                      meta.get("latent_dim", 2), device=device,
                      **_imspec_kwargs(meta))
    if model_type in ("reg", "cls"):
        from .classifier import Classifier
        from .regressor import Regressor
        return (Regressor if model_type == "reg" else Classifier)(
            meta.get("backbone", "mobilenet"),
            meta["out_dim" if model_type == "reg" else "nb_classes"],
            input_channels=meta.get("in_channels", 1), device=device)
    if model_type == "denoising_autoencoder":
        from .denoiser import DenoisingAutoencoder
        return DenoisingAutoencoder(
            **{k: meta[k] for k in _DENOISER_KEYS if k in meta},
            device=device)
    if model_type == "vae":
        from . import dgm
        cls_name = meta.get("vae_type", "VAE")
        if cls_name not in ("VAE", "rVAE", "jVAE", "jrVAE"):
            raise ValueError(f"Unknown VAE type in checkpoint: {cls_name}")
        net_kwargs = {k: meta[k] for k in _VAE_KEYS
                      if meta.get(k) is not None}
        if cls_name in ("rVAE", "jrVAE"):
            net_kwargs["translation"] = meta.get("coord", 3) == 3
        if cls_name in ("jVAE", "jrVAE"):
            net_kwargs["discrete_dim"] = list(meta["discrete_dim"])
        return getattr(dgm, cls_name)(
            tuple(meta["in_dim"]), meta.get("latent_dim", 2),
            nb_classes=meta.get("nb_classes", 0), device=device,
            **net_kwargs)
    raise ValueError(f"Unknown model type in checkpoint: {model_type}")


def load_model(filepath: Source, device: str = "cuda"):
    """A trained model, on ``device`` (the card by default; "cpu" when
    asked for), from a ``.aoit`` file written by ``save_model``, a
    ``.aoi`` file written by the JAX package's ``save_model``, or either's
    ``(meta, arrays)`` in memory."""
    meta, arrays = resolve_checkpoint(filepath)
    model = build_model(meta, device)
    model.load_arrays(arrays)
    if meta.get("model_type") != "vae":
        model.meta_state_dict = {**model.meta_state_dict, **meta}
        return model
    # training-progress counters, so that a further fit goes on where this
    # one stopped (JAX `loaders.py:92-101`)
    if meta.get("num_iter") is not None:
        model.num_iter = int(meta["num_iter"])
    if meta.get("num_epochs") is not None:
        model.current_epoch = int(meta["num_epochs"])
    model.update_metadict()
    return model


def _load_typed(source: Source, expected: str, kind: str, device: str):
    meta, arrays = resolve_checkpoint(source)
    if meta.get("model_type") != expected:
        raise ValueError(f"Checkpoint holds a '{meta.get('model_type')}' "
                         f"model, not a {kind} model")
    return load_model((meta, arrays), device)


def load_seg_model(meta_dict: Source, device: str = "cuda"):
    """A Segmentor from its ``.aoit`` or ``.aoi`` file; other model types
    raise."""
    return _load_typed(meta_dict, "seg", "segmentation", device)


def load_imspec_model(meta_dict: Source, device: str = "cuda"):
    """An ImSpec model from its ``.aoit`` or ``.aoi`` file."""
    return _load_typed(meta_dict, "imspec", "imspec", device)


def load_reg_model(meta_dict: Source, device: str = "cuda"):
    """A Regressor from its ``.aoit`` or ``.aoi`` file."""
    return _load_typed(meta_dict, "reg", "regression", device)


def load_cls_model(meta_dict: Source, device: str = "cuda"):
    """A Classifier from its ``.aoit`` or ``.aoi`` file."""
    return _load_typed(meta_dict, "cls", "classification", device)


def load_vae_model(meta_dict: Source, device: str = "cuda"):
    """A VAE, rVAE, jVAE or jrVAE from its ``.aoit`` or ``.aoi`` file."""
    return _load_typed(meta_dict, "vae", "VAE", device)


def load_denoising_autoencoder(meta_dict: Source, device: str = "cuda"):
    """A DenoisingAutoencoder from its ``.aoit`` or ``.aoi`` file."""
    return _load_typed(meta_dict, "denoising_autoencoder", "denoiser",
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


def load_ensemble(filepath: Source, device: str = "cuda"
                  ) -> Tuple[nn.Module, Dict[int, Dict[str, Any]]]:
    """(the net with the ensemble's final weights, {member: state_dict})
    from a ``<name>_ensemble_metadict.aoit`` file written by the ensemble
    trainers or the JAX package's ``<name>_ensemble_metadict.aoi``, on
    ``device`` (the card by default; "cpu" when asked for). Each member's
    ``state_dict`` holds its own BatchNorm statistics: a JAX member takes
    its ``ensemble_batch_stats`` entry, or else the baseline's shared
    ``batch_stats`` (SWAG samples), as JAX `loaders.py:161-180` does. The
    net is rebuilt from the metadict's dims and widths."""
    meta, arrays = resolve_checkpoint(filepath)
    device = resolve_device(device)
    net = _skeleton(meta)
    if is_jax_tree(arrays):
        bridge = fcnn_from_jax if meta.get("model_type") == "seg" \
            else signal_ed_from_jax
        shared = arrays.get("batch_stats")
        net.load_state_dict(bridge(arrays["params"], shared, meta))
        member_stats = arrays.get("ensemble_batch_stats") or {}
        ensemble = ensemble_from_jax(
            {k: {"params": v, "batch_stats": member_stats.get(k, shared)}
             for k, v in arrays["ensemble"].items()}, meta)
    else:
        net.load_state_dict(arrays["params"])
        ensemble = arrays["ensemble"]
    net.to(device).eval()
    ensemble = {int(k): {n: t.to(device) for n, t in v.items()}
                for k, v in ensemble.items()}
    return net, dict(sorted(ensemble.items()))
