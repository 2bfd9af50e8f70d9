"""Splits the benchmark's serve calls by the program's own spans
(``atomai_tpu_torch.core.profiling``) on a CUDA card.

For each cell named, the cell is set up as ``benchmark/run.py`` sets it up
(its driver's ``setup``: inputs and served weights from ``--seed``, the
program's objects, the warm-up), ``--calls`` calls are timed untraced,
then as many run under ``core.profiling.trace`` (host ops and the card's
kernels; the Chrome trace, spans included, goes to
``--out``/<cell>/trace.json) and as many under a profile of the card's
activity alone, as the benchmark's traced stretch takes it. For each
profiled stretch one JSON line gives:

- ``idle_ms``: the device's idle time a call, put down to the innermost
  program span over it (else ``bench.<call>``, the benchmark's span
  around the call, else ``outside``), and the share of the idle time that
  program spans cover;
- ``root_cover``: the share of the benchmark's spans around the calls
  that the program's root spans cover;
- ``spans``: the program's spans a call (count, total and self ms);
- ``bench_untraced_ms``: the benchmark's spans a call, untraced.

Each line is also kept as ``--out``/<cell>/breakdown.<mode>.json.

    python3 scripts/serve_span_breakdown.py [--cells ens512.serve ...]
        [--calls 8] [--seed 1] [--out chiprun_out/span_breakdown]
"""

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def analyse(prof, bench_items, program, calls):
    """The idle split, root cover and span summary of one profiled
    stretch (``prof``: a finished ``torch.profiler.profile``)."""
    from torch.autograd import DeviceType

    from atomai_tpu_torch.core import profiling
    from tracing import _innermost, _union
    (w0, w1), = [(s, e) for n, s, e in bench_items if n == "bench.traced"]
    calls_b = [(n, s, e) for n, s, e in bench_items if n != "bench.traced"]
    prog = [(r.name, r.start_ns, r.end_ns) for r in program
            if r.start_ns >= w0 and r.end_ns <= w1]
    dev = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA and
           not ev.is_user_annotation()]
    busy = _union([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cuts = sorted({t for _, s, e in prog + calls_b for t in (s, e)})
    split, total = {}, 0
    for s, e in idle:
        inner = [t for t in cuts if s < t < e]
        for a, b in zip([s] + inner, inner + [e]):
            mid = (a + b) // 2
            name = _innermost(prog, mid)
            if name == "outside":
                name = _innermost(calls_b, mid)
            split[name] = split.get(name, 0) + (b - a)
            total += b - a
    on_program = sum(v for k, v in split.items()
                     if not k.startswith("bench.") and k != "outside")
    roots = [(s, e) for r in program if r.parent is None
             for s, e in [(r.start_ns, r.end_ns)]]
    cover = {}
    for n, s, e in calls_b:
        inside = _union([(max(a, s), min(b, e)) for a, b in roots
                         if b > s and a < e])
        c = cover.setdefault(n, [0, 0])
        c[0] += sum(b - a for a, b in inside)
        c[1] += e - s
    stats = profiling.summary()["spans"]
    return {
        "window_ms": (w1 - w0) / 1e6 / calls,
        "busy_ms": sum(e - s for s, e in busy) / 1e6 / calls,
        "idle_ms": {k: v / 1e6 / calls for k, v in
                    sorted(split.items(), key=lambda kv: -kv[1])},
        "idle_on_program_spans": on_program / total if total else None,
        "root_cover": {n: c[0] / c[1] for n, c in cover.items()},
        "root_cover_all": sum(c[0] for c in cover.values()) /
        max(1, sum(c[1] for c in cover.values())),
        "spans": {n: {"count": s["count"] / calls,
                      "total_ms": 1e3 * s["total_s"] / calls,
                      "self_ms": 1e3 * s["self_s"] / calls}
                  for n, s in sorted(stats.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+",
                    default=["ens512.serve", "unet256.serve"])
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "span_breakdown"))
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, REPO]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import harness
    import tracing as btrace
    from atomai_tpu_torch.core import profiling
    if not torch.cuda.is_available():
        print("serve_span_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = harness.load_json(REPO, "BENCHMARK.json")
    for name in args.cells:
        cell = harness.load_cell(bench, name)
        driver = harness.load_module("drivers", cell.traffic["driver"])
        run = harness.Run(cell, args.seed, 0.0, True, device,
                          t_start=time.time())
        st = driver.setup(run)
        gc.collect()
        gc.freeze()
        run.spans.clear()
        i = 0
        for _ in range(args.calls):
            driver.request(run, st, i)
            run.sync()
            i += 1
        untraced = {k: 1e3 * sum(v) / len(v) for k, v in run.spans.items()}
        out_dir = os.path.join(args.out, name)
        for mode in ("trace", "cuda_only"):
            profiling.reset()
            run.traced_spans = btrace.Spans()
            ctx = profiling.trace(out_dir) if mode == "trace" else \
                profile(activities=[ProfilerActivity.CUDA])
            with ctx as prof:
                enabled = torch.autograd.profiler._is_profiler_enabled
                with run.traced_spans.span("bench.traced"):
                    for _ in range(args.calls):
                        driver.request(run, st, i)
                        run.sync()
                        i += 1
            line = {"cell": name, "mode": mode, "calls": args.calls,
                    "profiler_flag_on": enabled,
                    "bench_untraced_ms": untraced,
                    **analyse(prof, run.traced_spans.items,
                              profiling.spans(), args.calls)}
            run.traced_spans = None
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"breakdown.{mode}.json"),
                      "w") as f:
                json.dump(line, f, indent=1)
            print(json.dumps(line), flush=True)
        gc.unfreeze()
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
