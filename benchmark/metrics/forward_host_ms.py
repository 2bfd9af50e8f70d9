"""Host milliseconds a request issuing the served net's forward: the self
time of the program's ``predictor.forward`` spans (the net's launches, the
activation and the layout) in the traced stretch, over its requests; the
host-side twin of ``forward_device_ms``."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("predictor.forward")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["self_s"] / ctx.traced.requests
