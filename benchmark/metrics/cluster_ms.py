"""Host milliseconds a request clustering the members' atoms: the time of
the program's ``cluster.coord`` spans (``cluster_coord``: concatenation,
DBSCAN, the per-cluster mean and variance loop) in the traced stretch,
over its requests."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    s = summary()["spans"].get("cluster.coord")
    if not s or not ctx.traced.requests:
        return None
    return 1e3 * s["total_s"] / ctx.traced.requests
