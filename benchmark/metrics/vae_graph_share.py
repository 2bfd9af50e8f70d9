"""The share of the window's rVAE training steps replayed from a CUDA
graph: the program's ``vae.graph_replay`` counter over it plus
``vae.eager_step`` (``core.profiling``), each counted by the request that
ran the step, over the untraced and the traced stretch. None where the
program has neither counter."""


def read(ctx):
    counts = {}
    for part in (ctx.untraced, ctx.traced):
        for k, v in part.counts.items():
            counts[k] = counts.get(k, 0) + v
    if "vae_graph_replay" not in counts and "vae_eager_step" not in counts:
        return None
    replays = counts.get("vae_graph_replay", 0)
    total = replays + counts.get("vae_eager_step", 0)
    return 100.0 * replays / total if total else None
