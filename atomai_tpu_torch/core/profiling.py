"""Tracing and device-memory statistics (counterpart of
`atomai_tpu/core/profiling.py:23-57`): a ``torch.profiler`` trace written
as a Chrome trace, named regions inside it, and the card's memory use
under the JAX package's key names."""

import contextlib
import os
from typing import Any, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profiles everything run inside (the host's ops, and the card's
    kernels where there is one) and writes ``logdir/trace.json`` (a Chrome
    trace: chrome://tracing or Perfetto) on exit; ``create_perfetto_link``
    prints where the file is, to open in https://ui.perfetto.dev (nothing
    is served or uploaded)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print(f"Open {os.path.abspath(path)} in https://ui.perfetto.dev")


def annotate(name: str):
    """Names a region inside a :func:`trace`."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> Dict[str, Dict[str, Any]]:
    """For each CUDA device, the bytes torch's allocator holds in tensors
    (``bytes_in_use``), its peak since the last reset
    (``peak_bytes_in_use``) and the card's memory (``bytes_limit``); with
    no CUDA device, ``{"cpu": {"bytes_in_use": None}}`` (the JAX package
    reports devices without statistics so)."""
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": None}}
    stats = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return stats


def block_until_ready(tree: Any) -> Any:
    """Waits for the card's work on every CUDA tensor of ``tree`` (a
    tensor, or nested lists, tuples and dicts of them) and returns
    ``tree``, for wall-clock timing."""
    devices = set()

    def visit(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
    visit(tree)
    for d in devices:
        torch.cuda.synchronize(d)
    return tree
