"""Readings of the controls that the limits of ``cells/*.json`` are set
against: the plain reference put in the program's place in the precision
below the one the configuration states (each bf16 conv in float8_e4m3fn,
the float32 coordinates in bfloat16), judged by the same numbers, against
the float32 reference, as a run judges the program. Each cell's driver
makes them (``control_readings``) from the inputs its runs make.

    python3 benchmark/controls.py --seeds 11 12 13 [--cells ...]

prints one JSON line a cell and seed (on the card, at the cells' own
sizes). ``tests/test_bench_control.py`` runs it at a small size on the CPU
and at full size on the card.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import harness  # noqa: E402

Q_COMPUTE = torch.float8_e4m3fn
Q_COORDS = torch.bfloat16


def readings(cell: harness.Cell, seed: int, device) -> dict:
    """{"control": numbers} of one cell and seed."""
    driver = harness.load_module("drivers", cell.traffic["driver"])
    run = harness.Run(cell, seed, 0.0, False, torch.device(device))
    return {"control": driver.control_readings(run, Q_COMPUTE, Q_COORDS)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cells", nargs="*")
    args = ap.parse_args()
    bench = harness.load_json(harness.REPO, "BENCHMARK.json")
    names = args.cells or [w["name"] for w in bench["workloads"]]
    for name in names:
        cell = harness.load_cell(bench, name)
        for seed in args.seeds:
            out = readings(cell, seed, "cuda")
            print(json.dumps({"cell": name, "seed": seed, **out,
                              "limits": cell.limits}), flush=True)


if __name__ == "__main__":
    main()
