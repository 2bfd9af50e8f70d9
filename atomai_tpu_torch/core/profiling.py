"""Tracing and device-memory statistics (counterpart of
`atomai_tpu/core/profiling.py:23-57`): a ``torch.profiler`` trace written
as a Chrome trace, named regions inside it, and the card's memory use
under the JAX package's key names."""

import contextlib
import os
from typing import Any, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles everything run inside (the host's ops, and the card's
    kernels where there is one) and writes ``logdir/trace.json`` (a Chrome
    trace: chrome://tracing or Perfetto) on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
