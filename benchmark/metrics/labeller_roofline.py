"""The connected-component labeller's share of its roofline: the bytes its
labellings of the traced calls must move (``roofline.locator_bytes``:
masks in, labels out, one root and three sums a blob) over 3.35 TB/s, over
the summed time of its kernels (``cc_*``) in the trace."""

import roofline
import tracing


def read(ctx):
    nbytes = ctx.traced.counts.get("labeller_bytes", 0)
    if ctx.trace is None or not nbytes:
        return None
    t = ctx.trace.seconds(tracing.is_labeller)
    if t <= 0:
        return None
    return 100.0 * nbytes / roofline.H100_HBM_BYTES / t
