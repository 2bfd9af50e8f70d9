"""The posterior draw's share of the card's float64 peak: the float64
operations of the traced calls' draws (``roofline_gp.draw_flops``: the
training points' kernel matrix, factor and weights; the candidates' kernel
matrices, mean, triangular solve, V^T V, Cholesky factor and L eps) over
67 TFLOP/s, over the summed time of the float64 linear-algebra kernels in
the trace, every one of which a draw runs. Those are selected by name:
cuBLAS's ``sm90_xmma_gemm_f64f64`` and ``sm90_xmma_syrk_*_f64f64``
kernels, CUTLASS's ``d884gemm``, and the cuSOLVER and cuBLAS kernels
templated on ``double`` (``getrf_wo_pivot``, ``trsm``, ``gemvx``,
``splitKreduce``); torch's own elementwise kernels (``at::native``) are
left out. ``benchmark/tests/test_bench_dkl.py`` holds the selection to the
kernels of a float64 Cholesky factor on the card."""

import re

import roofline_gp

_F64 = re.compile(r"f64f64|d884gemm|<double\b|, double\b")


def is_f64_linalg(name: str) -> bool:
    return "at::native" not in name and not name.startswith("Mem") and \
        bool(_F64.search(name))


def read(ctx):
    flops = ctx.traced.counts.get("draw_flops", 0)
    if ctx.trace is None or not flops:
        return None
    t = ctx.trace.seconds(is_f64_linalg)
    if t <= 0:
        return None
    return 100.0 * flops / roofline_gp.H100_FP64_FLOPS / t
