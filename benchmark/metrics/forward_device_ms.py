"""Device milliseconds of the predictor a frame: every kernel's time in the
traced calls but the labeller's (``cc_*``) and the copies, over the frames
returned."""

import tracing


def read(ctx):
    frames = ctx.traced.counts.get("frames", 0)
    if ctx.trace is None or not frames or not ctx.trace.device_events:
        return None
    return 1e3 * ctx.trace.seconds(
        lambda n: not tracing.is_copy(n) and not tracing.is_labeller(n)) / frames
