"""The share of the exact GP's training steps whose marginal likelihood,
solve and gradient ran on the program's kernel pair: the program's
``gp.mll_kernel`` counter over it plus ``gp.mll_library``
(``core.profiling``; steps replayed from a CUDA graph counted too),
cumulative over the process (set-up and warm-up included). None where the
program has neither counter."""


def read(ctx):
    try:
        from atomai_tpu_torch.core.profiling import summary
    except ImportError:
        return None
    counters = summary()["counters"]
    if "gp.mll_kernel" not in counters and "gp.mll_library" not in counters:
        return None
    kernel = counters.get("gp.mll_kernel", 0)
    return 100.0 * kernel / (kernel + counters.get("gp.mll_library", 0))
