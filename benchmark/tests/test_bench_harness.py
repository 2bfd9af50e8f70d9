"""The harness: BENCHMARK.json against its contract, every file a cell,
configuration, traffic mix and metric needs found by name, the entry
point's refusals, and each traffic driver run whole at a small size on the
CPU."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import harness
from conftest import BENCH, REPO, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:       # setup_s, one more end-to-end, one per-layer
        c = harness.load_cell(bench, cell)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        driver = harness.load_module("drivers", cell.traffic["driver"])
        for fn in ("setup", "request", "check"):
            assert callable(getattr(driver, fn))
        assert driver.RATE in {m["name"] for m in bench["end_to_end"]}
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == []
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_run_parses_its_arguments_and_refuses_without_a_card(bench):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import run
    for cell in [w["name"] for w in bench["workloads"]]:
        assert run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                         "--seconds", "1", "--trace", "1"]) == 2
    with pytest.raises(SystemExit):
        run.main(["--workload", "unet256.serve", "--seed", "1"])
    with pytest.raises(KeyError):
        run.main(["--workload", "no.such", "--seed", "1", "--seconds", "1",
                  "--trace", "0"])


def test_run_in_a_bare_checkout_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "unet256.serve", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["unet256.serve", "ens512.serve"])
def test_driver_runs_a_small_cell_on_the_cpu(bench, cell, trace):
    c = tiny(harness.load_cell(bench, cell))
    out = harness.run_cell(c, 2 ** 31 + 11, 0.5, bool(trace),
                           torch.device("cpu"), 0.0)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1 + (2 if trace else 0)
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(c.limits)
    assert all(math.isfinite(v["value"]) for v in res["checks"].values())
    if trace:
        assert res["metrics"]       # the host-clock readers find work
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in c.end_to_end}
        assert set(res["metrics"]) == names
    json.dumps(res)


def test_same_seed_same_inputs(bench):
    import inputs
    cfg = harness.load_cell(bench, "unet256.serve").config
    spec = dict(cfg["data"]["train"], n_images=2, size=64)
    a = inputs.frames(spec, harness.seeds(2 ** 33 + 1, 1)[0])
    b = inputs.frames(spec, harness.seeds(2 ** 33 + 1, 1)[0])
    assert all((x == y).all() for x, y in zip(a, b))
    assert harness.seeds(5, 3) != harness.seeds(6, 3)


def test_reservoir_is_uniform_and_bounded():
    import inputs
    hits = [0] * 10
    for s in range(2000):
        r = inputs.Reservoir(3, s)
        for i in range(10):
            r.offer(lambda i=i: i)
        assert len(r.items) == 3
        for i in r.items:
            hits[i] += 1
    assert min(hits) > 0.8 * 600 and max(hits) < 1.2 * 600


def test_trace_summary_unions_intervals_and_names_gaps():
    import tracing
    assert tracing._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    spans = [("bench.predict", 0, 100), ("bench.locate", 40, 60)]
    assert tracing._innermost(spans, 50) == "bench.locate"
    assert tracing._innermost(spans, 10) == "bench.predict"
    s = tracing.TraceSummary(window_s=2.0, busy_s=0.5, device_events=3)
    assert tracing.idle_share(s) == 75.0
    assert tracing.idle_share(tracing.TraceSummary()) is None
