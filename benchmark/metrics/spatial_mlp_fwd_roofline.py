"""The spatial-MLP forward kernel's share of its roofline: the bound of a
step's forward (``roofline_vae.bound_s``: the larger of its FLOPs over 989
TFLOP/s and its bytes over 3.35 TB/s) times the traced steps, over the
summed time of the forward's launches in the trace: ``fwd_wgmma`` (or the
staged ``fwd_kernel``) and its half of the weights' ``pack_kernel``, which
the forward and the backward each launch once a step."""

import re

FORWARD = re.compile(r"\(anonymous namespace\)::fwd_(wgmma|kernel)\b")
PACK = re.compile(r"\(anonymous namespace\)::pack_kernel\b")


def kernel_seconds(trace, main) -> float:
    """Seconds of a pass's own kernels plus half of the pack launches."""
    return trace.seconds(lambda n: bool(main.search(n))) + \
        0.5 * trace.seconds(lambda n: bool(PACK.search(n)))


def read(ctx, which=FORWARD, bound="fwd_bound_s"):
    steps = ctx.traced.counts.get("steps", 0)
    b = ctx.constants.get(bound)
    if ctx.trace is None or not steps or not b:
        return None
    t = kernel_seconds(ctx.trace, which)
    if t <= 0:
        return None
    return 100.0 * b * steps / t
