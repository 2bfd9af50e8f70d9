"""Model loading from the port's own checkpoints.

Counterpart of `atomai_tpu/models/loaders.py:30-118` for the model types
the port has: ``seg`` (Segmentor) and ``vae`` (VAE, rVAE). The model is
rebuilt from the constructor arguments in the file's metadict, then its
weights are loaded. Other model types and the JAX package's ``.aoi`` files
(msgpack payload) are ROADMAP Queue 1 #20.
"""

from ..core.checkpoint import load_checkpoint

_NOT_PORTED = "ROADMAP Queue 1 #20"


def load_model(filepath: str, device: str = "cuda"):
    """A trained model, on ``device`` (the card by default; "cpu" when
    asked for), from a ``.aoit`` file written by ``save_model``."""
    if filepath.endswith(".aoi"):
        raise NotImplementedError(
            f"the port reads its own .aoit files only; reading the JAX "
            f"package's .aoi files is {_NOT_PORTED}")
    meta, arrays = load_checkpoint(filepath)
    model_type = meta.get("model_type")
    if model_type == "seg":
        from .segmentor import Segmentor
        net_kwargs = {k: meta[k] for k in
                      ("batch_norm", "dropout", "with_dilation",
                       "nb_filters", "layers", "upsampling")
                      if meta.get(k) is not None}
        model = Segmentor(meta.get("model", "Unet"),
                          meta.get("nb_classes", 1), device=device,
                          **net_kwargs)
        model.net.load_state_dict(arrays["params"])
        model.meta_state_dict = dict(meta)
        return model
    if model_type == "vae":
        from . import dgm
        cls_name = meta.get("vae_type", "VAE")
        if cls_name not in ("VAE", "rVAE"):
            raise NotImplementedError(
                f"{cls_name} is not ported yet (ROADMAP Queue 1 #14)")
        net_kwargs = {k: meta[k] for k in
                      ("numlayers_encoder", "numlayers_decoder",
                       "numhidden_encoder", "numhidden_decoder",
                       "conv_encoder", "skip", "sigmoid_out",
                       "softplus_out")
                      if meta.get(k) is not None}
        if cls_name == "rVAE":
            net_kwargs["translation"] = meta.get("coord", 3) == 3
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
    raise NotImplementedError(
        f"loading a '{model_type}' model is not ported yet ({_NOT_PORTED})")
