"""The general harness: one run of one cell, driven by the files that
``BENCHMARK.json`` names. Nothing here knows a cell, a configuration or a
metric by name.

A cell ``<cell>`` of ``BENCHMARK.json`` names a configuration and a traffic
mix. The harness reads ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``driver`` names ``drivers/<driver>.py``) and ``cells/<cell>.json``
(the limits of the numbers that decide ``correct``), runs the driver's
``setup``, then its ``request`` back to back, a closed loop with one caller,
until ``--seconds`` have passed (the window ends when the request in flight
returns), then the driver's ``check``. With ``--trace 1`` the window's last
requests (the mix's ``traced_requests``) run under the profiler, and each
per-layer metric of the cell is read by ``metrics/<metric>.py``.

A driver module has:
- ``setup(run) -> state``: inputs, weights, the program's objects and the
  warm-up of every shape the window uses;
- ``request(run, state, i) -> counts``: one request, all its work done and
  its results on the host; ``counts`` (numbers) are summed over requests;
  ``samples`` is the work an end-to-end rate counts;
- ``check(run, state) -> {name: value}``: the numbers compared with the
  cell's limits, worked out after the window by the plain reference;
- ``RATE``: the end-to-end metric its samples per second report, and
  ``LATENCY`` (optional): the one its 95th percentile of request latency
  reports;
- ``control_readings(run, compute_dtype, coord_dtype) -> {name: value}``:
  the numbers of ``check`` with the plain reference one precision lower in
  the program's place, on the inputs a run of that seed makes
  (``controls.py``).

``setup`` or ``check`` may put constants that the readers need (the FLOPs
of a frame, ...) into ``run.constants``.
"""

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import tracing as btrace

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "atomai_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported by path."""
    path = os.path.join(ROOT, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one cell's run reads from files."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(bench: dict, name: str) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO, configs[w["config"]]["file"])
    traffic = load_json(ROOT, "traffic", w["traffic"] + ".json")
    limits = load_json(ROOT, "cells", name + ".json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _listed(m, name, names)]
    return Cell(name, w, config, traffic, limits, e2e, per_layer)


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from the run's ``--seed``."""
    return [int(s) for s in
            np.random.SeedSequence(abs(int(seed))).generate_state(n)]


@dataclass
class Run:
    """What a driver gets: the cell's files, the seed, the device and a
    recorder of spans and counts."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Dict[str, List[float]] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)
    constants: Dict[str, float] = field(default_factory=dict)
    t_start: float = 0.0
    traced_spans: Optional[btrace.Spans] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, phase: str) -> None:
        """Records the seconds since the process started at the end of a
        phase of set-up (``info["setup_marks"]``)."""
        self.info.setdefault("setup_marks", {})[phase] = \
            time.time() - self.t_start

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A benchmark span around a call into a layer (ended by a
        synchronise when ``sync``): its host seconds under
        ``spans[name]``, or while tracing a named range of the trace."""
        if self.traced_spans is not None:
            with self.traced_spans.span("bench." + name):
                yield
                if sync:
                    self.sync()
            return
        t0 = time.perf_counter()
        yield
        if sync:
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def smi() -> Optional[str]:
    """The card's name, power limit, clocks, draw and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


@dataclass
class Part:
    """Requests of one stretch of the window."""
    requests: int = 0
    failed: int = 0
    seconds: float = 0.0
    counts: Dict[str, float] = field(default_factory=dict)
    latencies: List[float] = field(default_factory=list)


def _requests(run: Run, driver, state, part: Part, first: int,
              until: Optional[float], n: Optional[int]) -> None:
    t0 = time.perf_counter()
    i = first
    while True:
        if n is not None and part.requests >= n:
            break
        if until is not None and time.perf_counter() >= until:
            break
        t = time.perf_counter()
        try:
            counts = driver.request(run, state, i)
            run.sync()
            part.latencies.append(time.perf_counter() - t)
            for k, v in counts.items():
                part.counts[k] = part.counts.get(k, 0) + v
        except Exception:           # a failed request: counted, reported
            part.failed += 1
            part.latencies.append(math.inf)
            if part.failed == 1:
                traceback.print_exc(file=sys.stderr)
        part.requests += 1
        i += 1
    part.seconds = time.perf_counter() - t0


def _p95(lat: List[float]) -> float:
    return float(np.percentile(np.asarray(lat, np.float64), 95)) \
        if lat else math.inf


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e308


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """One run: the result's keys, and ``checks`` beside them."""
    driver = load_module("drivers", cell.traffic["driver"])
    run = Run(cell, seed, seconds, trace, device, t_start=t_start)
    run.mark("harness")
    state = driver.setup(run)
    run.spans.clear()
    gc.collect()
    gc.freeze()               # set-up's objects leave the collector's scans
    if device.type == "cuda":
        run.sync()
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.time()
    setup_s = t_window - t_start
    main, traced = Part(), Part()
    t_end = time.perf_counter() + seconds
    _requests(run, driver, state, main, 0, t_end, None)
    summary = None
    if trace:
        run.traced_spans = btrace.Spans()
        with btrace.traced(run.traced_spans) as holder:
            _requests(run, driver, state, traced, main.requests, None,
                      int(cell.traffic["traced_requests"]))
        summary = holder.summary
        run.traced_spans = None
        run.info["trace"] = {
            "device_events": summary.device_events, "lead_s": summary.lead_s,
            "labeller_ops": {n: s for n, s in summary.by_name.items()
                             if btrace.is_labeller(n)}}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    smi_after = smi() if device.type == "cuda" else None
    run.info["latency_ms"] = [float(np.percentile(main.latencies, q)) * 1e3
                              for q in (0, 25, 50, 75, 95, 100)] \
        if main.latencies else None
    run.info.update(requests=main.requests, traced_requests=traced.requests,
                    window_s=main.seconds + traced.seconds,
                    untraced_s=main.seconds, traced_s=traced.seconds,
                    counts=main.counts, traced_counts=traced.counts,
                    smi_after=smi_after)
    if trace and traced.seconds > 0 and main.seconds > 0:
        run.info["rate_untraced"] = main.counts.get("samples", 0) / \
            main.seconds
        run.info["rate_traced"] = traced.counts.get("samples", 0) / \
            traced.seconds
    values = driver.check(run, state)
    del state
    checks = {k: {"value": _finite(float(values.get(k, math.inf))),
                  "limit": float(lim)} for k, lim in cell.limits.items()}
    failed = main.failed + traced.failed
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()) and \
        set(values) >= set(cell.limits)
    metrics = {}
    if not trace:
        all_e2e = {"setup_s": setup_s}
        rate = main.counts.get("samples", 0) / main.seconds \
            if main.seconds > 0 else 0.0
        all_e2e[driver.RATE] = rate
        if getattr(driver, "LATENCY", None):
            all_e2e[driver.LATENCY] = _p95(main.latencies) * 1e3
        for m in cell.end_to_end:
            if m["name"] in all_e2e:
                metrics[m["name"]] = {"value": _finite(all_e2e[m["name"]]),
                                      "unit": m["unit"]}
    else:
        ctx = ReadContext(main, traced, summary, run.spans, run.constants)
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = summary.busy_s if summary else 0.0
        dev["window_s"] = summary.window_s if summary else 0.0
    result = {"correct": bool(correct),
              "attempted": main.requests + traced.requests,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = btrace.breakdown(summary)
    result["checks"] = checks
    return {"result": result, "info": run.info}


@dataclass
class ReadContext:
    """What a per-layer reader sees: the untraced and the traced stretch of
    the window (requests, seconds, summed counts), the device trace of the
    traced stretch, the host spans of the untraced stretch, and the
    driver's constants."""
    untraced: Part
    traced: Part
    trace: Optional[btrace.TraceSummary]
    spans: Dict[str, List[float]]
    constants: Dict[str, float]
