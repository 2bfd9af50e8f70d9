"""Host milliseconds a request in the Thompson draw: the time of the
program's ``dkl.thompson`` spans (the candidates' upload, the posterior,
its factor, the draw's fetch and its argmax) in the traced stretch, over
its requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("dkl.thompson")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["total_s"] / ctx.traced.requests
