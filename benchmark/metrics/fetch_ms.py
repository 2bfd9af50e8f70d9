"""Device milliseconds of device-to-host copies a frame in the traced
calls: the maps and coordinates going to the host."""

import tracing


def read(ctx):
    frames = ctx.traced.counts.get("frames", 0)
    if ctx.trace is None or not frames:
        return None
    s = ctx.trace.seconds(tracing.is_d2h)
    return 1e3 * s / frames if s > 0 else None
