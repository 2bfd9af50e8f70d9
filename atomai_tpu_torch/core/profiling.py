"""Spans, counters, traces and device-memory statistics (counterpart of
`atomai_tpu/core/profiling.py:23-57`).

Operator's note. Run the calls of interest under :func:`trace` (which
writes ``logdir/trace.json``, a Chrome trace with the program's spans on
the kernels' timeline) or under any ``torch.profiler.profile`` of your
own, then read :func:`summary`::

    with profiling.trace("prof"):
        maps, coords = model.predict(stack)
    profiling.summary()["spans"]["predictor.preprocess"]
    # {"count": 1, "total_s": ..., "self_s": ...}

A span (``with profiling.span("<layer>.<stage>"):``) is recorded only
while a profiler is recording; otherwise it costs one flag check and
returns a shared no-op. Its start and end come from ``time.time_ns()``, the
clock of the profiler's events, so spans lie over the device's kernels
and copies. A span never synchronises, copies or allocates on the device.
The recorder holds the spans of the latest profiled stretch only (a new
one starts when a span opens under a profiler after one opened without,
or after :func:`reset`), at most ``CAPACITY`` of them, and writes nothing.
Counters (:func:`count`) are always on and cumulative.

Span names in the port: ``predictor.run``, ``predictor.predict``,
``predictor.ensemble_forward`` (roots: one call each),
``predictor.preprocess``, ``predictor.forward``, ``locator.ensemble_locate``
(root), ``locator.run``, ``cluster.coord``, ``cluster.dbscan``, and the
host's waits on the card: ``predictor.upload``, ``locator.upload``,
``predictor.fetch``, ``locator.fetch``, ``labeller.fetch``. Deep kernel
learning (``trainers/gptrainer.py``, ``models/dklgp/dklgpr.py``):
``dkl.fit`` (root: one ``run``), ``dkl.fit.fetch`` (a chunk's losses),
``dkl.upload`` (``set_data``'s copies and a draw's noise),
``dkl.thompson`` (root: one draw and its argmax) and ``dkl.fetch`` (a
draw to the host). Counters: ``labeller.launches``,
``spatial_mlp.forward_launches``, ``spatial_mlp.backward_launches``
(``spatial_mlp.backward_pipelined_launches``: those that took the
pipelined ``bwd_wgmma``), ``spd_mll.forward_launches``,
``spd_mll.backward_launches``, the exact GP's training steps by the route of their MLL (``gp.mll_kernel``: the
kernel pair of ``ops/spd_mll.py``; ``gp.mll_library``: cuSOLVER or LAPACK
under autograd), and
``EnsemblePredictor``'s member forwards of a chunk, one of three each:
``predictor.eager_forward`` (eager: off the card, or a signature's first
sighting), ``predictor.graph_capture`` (captured, then replayed),
``predictor.graph_replay`` (replayed from its CUDA graph).
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 65536


class SpanRecord(NamedTuple):
    """One finished span: ``root`` (the id of its outermost span) names
    the call it belongs to; ``parent`` is None for a root."""
    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int


class _NoSpan:
    """The shared context of a span taken with no profiler recording."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_id", "_parent", "_root", "_t0")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        stack = self._rec._stack()
        self._id = next(self._rec._ids)
        if stack:
            self._parent, self._root = stack[-1]._id, stack[-1]._root
        else:
            self._parent, self._root = None, self._id
        stack.append(self)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self._rec._stack().pop()
        self._rec._done.append(SpanRecord(
            self._id, self._parent, self._root, self._name, self._t0, t1))
        return False


class Recorder:
    """Spans of the latest profiled stretch (a ring of ``capacity``) and
    cumulative counters."""

    def __init__(self, capacity: int = CAPACITY):
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._live = False      # the last span opened under a profiler

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str):
        if not _autograd_profiler._is_profiler_enabled:
            self._live = False
            return _NO_SPAN
        if not self._live:
            self._live = True
            self._done.clear()
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> List[SpanRecord]:
        return list(self._done)

    def summary(self) -> Dict[str, Any]:
        records = self.spans()
        # a span's children ran on its thread, one after another
        in_children: Dict[int, int] = {}
        for r in records:
            if r.parent is not None:
                in_children[r.parent] = in_children.get(r.parent, 0) + \
                    r.end_ns - r.start_ns
        out: Dict[str, Dict[str, float]] = {}
        for r in records:
            s = out.setdefault(r.name,
                               {"count": 0, "total_s": 0.0, "self_s": 0.0})
            d = r.end_ns - r.start_ns
            s["count"] += 1
            s["total_s"] += d * 1e-9
            s["self_s"] += (d - in_children.get(r.id, 0)) * 1e-9
        with self._lock:
            counters = dict(self._counters)
        return {"spans": out, "counters": counters}

    def reset(self) -> None:
        self._done.clear()
        self._live = False
        with self._lock:
            self._counters.clear()


_RECORDER = Recorder()


def span(name: str):
    """A named region of the program (``<layer>.<stage>``), recorded
    with its parent and root span while a profiler is recording."""
    return _RECORDER.span(name)


annotate = span


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    _RECORDER.count(name, n)


def spans() -> List[SpanRecord]:
    """The recorded spans of the latest profiled stretch, in the order
    they ended."""
    return _RECORDER.spans()


def summary() -> Dict[str, Any]:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}}``: self seconds are a span's duration less the part its
    child spans cover."""
    return _RECORDER.summary()


def reset() -> None:
    """Forgets the recorded spans and zeroes the counters."""
    _RECORDER.reset()


def _write_spans(path: str, records: List[SpanRecord]) -> None:
    """Adds ``records`` to a Chrome trace as complete events of their
    own category (``program_span``), on the trace's time base."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
         "tid": "program spans", "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"id": r.id, "parent": r.parent, "root": r.root}}
        for r in records)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profiles everything run inside (the host's ops, and the card's
    kernels where there is one) and writes ``logdir/trace.json`` (a Chrome
    trace: chrome://tracing or Perfetto) on exit, with the program's spans;
    ``create_perfetto_link`` prints where the file is, to open in
    https://ui.perfetto.dev (nothing is served or uploaded)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [r for r in spans() if r.start_ns >= t0])
    if create_perfetto_link:
        print(f"Open {os.path.abspath(path)} in https://ui.perfetto.dev")


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
