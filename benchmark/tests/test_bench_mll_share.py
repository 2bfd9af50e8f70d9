"""``mll_kernel_share``, the reader of the program's exact-MLL route
counters: None where the program has neither (the parent's), their ratio
otherwise, and 0 on a CPU run, where every fit step takes the library
route."""

import torch

import harness
from test_bench_dkl import tiny_dkl


def _read():
    return harness.load_module("metrics", "mll_kernel_share").read(None)


def test_reads_the_counters():
    from atomai_tpu_torch.core import profiling
    profiling.reset()
    assert _read() is None
    profiling.count("predictor.graph_replay")
    assert _read() is None
    profiling.count("gp.mll_library", 2)
    assert _read() == 0.0
    profiling.count("gp.mll_kernel", 6)
    assert _read() == 75.0
    profiling.reset()


def test_listed_and_read_in_a_cpu_run(bench):
    from atomai_tpu_torch.core import profiling
    m = next(m for m in bench["per_layer"] if m["name"] == "mll_kernel_share")
    assert m["workloads"] == ["dkl64.suggest"] and m["unit"] == "%"
    assert m["moves"] == "call_p95_ms" and m["source"] == "program_counter"
    profiling.reset()
    out = harness.run_cell(tiny_dkl(bench), 2 ** 31 + 41, 0.3, True,
                           torch.device("cpu"), 0.0)
    assert out["result"]["metrics"]["mll_kernel_share"]["value"] == 0.0
    profiling.reset()
