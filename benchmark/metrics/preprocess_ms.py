"""Host milliseconds a request in the predictors' preprocess: the self time
of the program's ``predictor.preprocess`` spans (NumPy shape fix-ups,
padding, ``format_image``, normalising; their ``predictor.upload`` left
out) in the traced stretch, over its requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("predictor.preprocess")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["self_s"] / ctx.traced.requests
