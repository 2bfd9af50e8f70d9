"""``forward_graph_share``, the reader of the program's forward counters:
None where the program has none of them (the parent's), their ratio
otherwise, and 0 on a CPU run, where every chunk runs eagerly."""

import torch

import harness
from conftest import tiny


def _read():
    return harness.load_module("metrics", "forward_graph_share").read(None)


def test_reads_the_counters():
    from atomai_tpu_torch.core import profiling
    profiling.reset()
    assert _read() is None
    profiling.count("predictor.graph_capture")
    assert _read() is None
    profiling.count("predictor.eager_forward")
    assert _read() == 0.0
    profiling.count("predictor.graph_replay", 9)
    assert _read() == 90.0
    profiling.reset()


def test_listed_and_read_in_a_cpu_run(bench):
    from atomai_tpu_torch.core import profiling
    m = next(m for m in bench["per_layer"]
             if m["name"] == "forward_graph_share")
    assert m["workloads"] == ["ens512.serve"] and m["unit"] == "%"
    profiling.reset()
    c = tiny(harness.load_cell(bench, "ens512.serve"))
    out = harness.run_cell(c, 2 ** 31 + 37, 0.5, True, torch.device("cpu"),
                           0.0)
    assert out["result"]["metrics"]["forward_graph_share"]["value"] == 0.0
    profiling.reset()
