"""Runs one cell of the benchmark once and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit); the checks are also the last lines
of standard error. Earlier lines of standard output hold what else a run
records (requests, atoms located, the card's clocks and power).

It exits non-zero and prints no result where torch sees no CUDA card or
fewer than the cell asks for, where the program cannot be imported, and
where JAX or the JAX package is loaded once the window has closed.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# every build and kernel cache under the checkout, at fixed paths
for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(REPO, ".bench_cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, REPO]
    import harness
    t_start = harness.process_start()
    bench = harness.load_json(REPO, "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)

    import torch
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    stdout = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)                 # the program's output goes to stderr
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result = out["result"]
    print("bench.info " + json.dumps(out["info"], default=str), file=stdout)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=stdout)
    stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
