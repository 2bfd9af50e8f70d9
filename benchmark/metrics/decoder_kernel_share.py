"""The share of the window's VAE training steps whose spatial decoder took
the fused route (one spatial-MLP call: the kernel pair of
``csrc/spatial_mlp.cu`` on the card): the program's
``vae.decoder_fused_step`` counter over it plus
``vae.decoder_layerwise_step`` (``core.profiling``; counted by the
trainer, replayed steps too), each counted by the request that ran the
step, over the untraced and the traced stretch. None where the program
has neither counter."""


def read(ctx):
    counts = {}
    for part in (ctx.untraced, ctx.traced):
        for k, v in part.counts.items():
            counts[k] = counts.get(k, 0) + v
    fused = counts.get("vae_decoder_fused_step")
    layerwise = counts.get("vae_decoder_layerwise_step")
    if fused is None and layerwise is None:
        return None
    total = (fused or 0) + (layerwise or 0)
    return 100.0 * (fused or 0) / total if total else None
