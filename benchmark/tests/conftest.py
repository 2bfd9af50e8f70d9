"""Tests of the benchmark harness. They run on the CPU at small sizes;
those marked ``card`` need a CUDA card and skip without one (decided in the
``card`` fixture, never at import).

    python -m pytest benchmark/tests -q -p xdist -n 6 --dist loadfile
    python -m pytest benchmark/tests -q -m card      # on the card
"""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def bench():
    import harness
    return harness.load_json(REPO, "BENCHMARK.json")


def tiny(cell):
    """``cell`` cut to a size the CPU runs in seconds: 8 frames of 64^2,
    3 steps of served-weight fitting."""
    cell = copy.copy(cell)
    cfg = copy.deepcopy(cell.config)
    for d in cfg["data"].values():
        d.update(n_images=8, size=64)
    if "frames" in cfg.get("serve", {}):
        cfg["serve"]["frames"] = 4
    for v in cfg.get("served_weights", {}).values():
        v.update(steps=3, batch=4)
    traffic = dict(cell.traffic, traced_requests=2)
    if "pool_frames" in traffic:
        traffic["pool_frames"] = 4
    cell.config, cell.traffic = cfg, traffic
    return cell
