"""The share of the predictor's chunk forwards replayed from a CUDA graph:
the program's ``predictor.graph_replay`` counter over it plus
``predictor.eager_forward`` (``core.profiling``), cumulative over the
process (set-up and warm-up included). None where the program has neither
counter."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    counters = summary()["counters"]
    if "predictor.graph_replay" not in counters and \
            "predictor.eager_forward" not in counters:
        return None
    replays = counters.get("predictor.graph_replay", 0)
    return 100.0 * replays / (replays + counters.get(
        "predictor.eager_forward", 0))
