"""Host milliseconds a request in the Locator: the self time of the
program's ``locator.run`` spans (threshold, tiling, the labeller's launch,
edge removal, the split into frames), whose only children are its
transfers (``locator.upload``, ``labeller.fetch``, ``locator.fetch``), in
the traced stretch, over its requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("locator.run")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["self_s"] / ctx.traced.requests
