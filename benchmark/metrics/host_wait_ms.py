"""Host milliseconds a request blocked on the card: the summed time of the
program's transfer spans (every ``*.upload`` and ``*.fetch``: pageable
copies in, results and counts back) in the traced stretch, over its
requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    waits = [s["total_s"] for name, s in summary()["spans"].items()
             if name.endswith((".upload", ".fetch"))]
    if not waits or not ctx.traced.requests:
        return None
    return 1e3 * sum(waits) / ctx.traced.requests
