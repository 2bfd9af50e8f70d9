"""Host milliseconds a request in the native DBSCAN alone: the time of the
program's ``cluster.dbscan`` spans (inside ``cluster.coord``) in the
traced stretch, over its requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("cluster.dbscan")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["total_s"] / ctx.traced.requests
