"""Host milliseconds a request in the DKL fit: the time of the program's
``dkl.fit`` spans (``dklGPR.fit``: compile, the training cycles' launches,
the loss fetch, the embedding statistics) in the traced stretch, over its
requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("dkl.fit")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["total_s"] / ctx.traced.requests
