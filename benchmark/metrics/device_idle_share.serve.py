"""The device's idle share of the traced stretch (``tracing.idle_share``)."""

import tracing


def read(ctx):
    return tracing.idle_share(ctx.trace)
