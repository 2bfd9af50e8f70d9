"""The traced stretch of a run: ``torch.profiler`` over the device's
activity alone (kernels, copies, sets; recording every host operation as
well doubled a config A fit), reduced in memory to what the per-layer
readers and the ``breakdown`` need, with the benchmark's own spans taken on
the host's wall clock, which the profiler's timestamps share. No trace file
is written.
"""

import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

WINDOW = "bench.traced"


@dataclass
class TraceSummary:
    """The device's work inside the traced window."""
    window_s: float = 0.0
    busy_s: float = 0.0              # union of kernel, copy and set intervals
    by_name: Dict[str, float] = field(default_factory=dict)  # seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: int = 0
    lead_s: float = 0.0      # first device event after the window opened

    def seconds(self, pred) -> float:
        """Summed device seconds of the operations whose name ``pred``
        accepts."""
        return sum(s for n, s in self.by_name.items() if pred(n))


_LABELLER = re.compile(r"\bcc_(local|border|roots|relabel)\b")


def is_labeller(name: str) -> bool:
    """The connected-component labeller's kernels (``csrc/cc_label.cu``),
    by their names as the profiler gives them."""
    return bool(_LABELLER.search(name))


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def is_d2h(name: str) -> bool:
    return name.startswith("Memcpy DtoH")


class Spans:
    """Host spans ``(name, start_ns, end_ns)`` on the wall clock."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


@contextlib.contextmanager
def traced(spans: Spans):
    """Profiles the device's activity of the enclosed code, as the span
    ``bench.traced``; yields a holder whose ``summary`` is set on exit."""
    holder = type("Traced", (), {"summary": None})()
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with spans.span(WINDOW):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    holder.summary = summarize(prof, spans.items)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(spans: List[Tuple[str, int, int]], t: int) -> str:
    best: Optional[Tuple[str, int, int]] = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "outside"


def summarize(prof, spans: List[Tuple[str, int, int]]) -> TraceSummary:
    """:class:`TraceSummary` of a finished profile and the host spans."""
    from torch.autograd import DeviceType
    dev = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CUDA and
           not ev.is_user_annotation()]
    win = [s for s in spans if s[0] == WINDOW]
    out = TraceSummary(device_events=len(dev))
    if not win:
        return out
    w0, w1 = win[0][1], win[0][2]
    out.window_s = (w1 - w0) * 1e-9
    if dev:
        out.lead_s = (min(s for _, s, _ in dev) - w0) * 1e-9
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
               if e > w0 and s < w1]
    for n, s, e in clipped:
        out.by_name[n] = out.by_name.get(n, 0.0) + (e - s) * 1e-9
    busy = _union([(s, e) for _, s, e in clipped])
    out.busy_s = sum(e - s for s, e in busy) * 1e-9
    inner = [s for s in spans if s[0] != WINDOW]
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out.gaps = [(_innermost(inner, (s + e) // 2), (e - s) * 1e-9)
                for s, e in gaps[:10]]
    return out


def breakdown(summary: TraceSummary) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each named by the benchmark span the host was in."""
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps]}


def idle_share(summary: Optional[TraceSummary]) -> Optional[float]:
    """Percent of the traced window in which no kernel or copy ran on the
    device: one minus the union of their intervals over the window."""
    if summary is None or summary.window_s <= 0 or not summary.device_events:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
