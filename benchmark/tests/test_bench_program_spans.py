"""The readers of the program's own spans (``atomai_tpu_torch.core.profiling``):
a small traced run on the CPU of every cell a reader lists gives a
finite, non-negative value, and with no span recorded each gives None."""

import math

import pytest
import torch

import harness
from conftest import tiny

READERS = ("preprocess_ms", "forward_host_ms", "locate_host_ms",
           "host_wait_ms", "cluster_ms", "dbscan_ms")


def _listing(bench, cell):
    return [m["name"] for m in bench["per_layer"]
            if m["name"] in READERS and cell in m["workloads"]]


def test_every_reader_is_listed(bench):
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = names[name]
        assert m["source"] == "host_clock" and m["moves"] == "call_p95_ms"
        assert m["workloads"]
    assert set(_listing(bench, "ens512.serve")) == set(READERS)
    assert set(_listing(bench, "unet256.serve")) == {
        "preprocess_ms", "forward_host_ms", "locate_host_ms", "host_wait_ms"}


@pytest.mark.parametrize("cell", ["unet256.serve", "ens512.serve"])
def test_readers_read_a_traced_run(bench, cell):
    c = tiny(harness.load_cell(bench, cell))
    out = harness.run_cell(c, 2 ** 31 + 23, 0.5, True, torch.device("cpu"),
                           0.0)
    metrics = out["result"]["metrics"]
    for name in _listing(bench, cell):
        assert name in metrics, name
        v = metrics[name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
    if cell == "ens512.serve":
        assert metrics["dbscan_ms"]["value"] <= metrics["cluster_ms"]["value"]


def test_readers_give_none_without_spans(bench):
    from atomai_tpu_torch.core import profiling
    c = tiny(harness.load_cell(bench, "ens512.serve"))
    profiling.reset()
    out = harness.run_cell(c, 2 ** 31 + 29, 0.5, False, torch.device("cpu"),
                           0.0)
    assert out["result"]["correct"] is True
    assert profiling.spans() == []          # no profiler: nothing recorded
    main = harness.Part(requests=out["info"]["requests"])
    ctx = harness.ReadContext(main, harness.Part(requests=2), None, {}, {})
    for name in READERS:
        assert harness.load_module("metrics", name).read(ctx) is None, name
