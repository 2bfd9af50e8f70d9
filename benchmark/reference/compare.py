"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each to be held to a limit:
the widest gap of a probability, of a coordinate, of a cluster mean; a
count or a shape that differs is an infinite gap.
"""

import math
from typing import Dict

import numpy as np


def _nan_inf(v: float) -> float:
    return math.inf if not math.isfinite(v) else float(v)


def max_abs_gap(a, b) -> float:
    """Largest |a - b|; shapes that differ are an infinite gap."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return _nan_inf(float(np.abs(a - b).max())) if a.size else 0.0


def coord_gap(prog: Dict[int, np.ndarray], ref: Dict[int, np.ndarray]
              ) -> float:
    """Largest gap of a [row, col, class] entry, frame by frame, in the
    same order; a frame whose atom count differs is an infinite gap."""
    if sorted(prog) != sorted(ref):
        return math.inf
    return max((max_abs_gap(np.asarray(prog[k])[:, :3],
                            np.asarray(ref[k])[:, :3])
                for k in ref), default=0.0)


def matched_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Largest distance from a reference point to the program's nearest,
    when the nearest points pair the two sets one to one; otherwise (or
    when the counts differ) infinite."""
    prog = np.asarray(prog, np.float64).reshape(-1, 2)
    ref = np.asarray(ref, np.float64).reshape(-1, 2)
    if len(prog) != len(ref):
        return math.inf
    if not len(ref):
        return 0.0
    d = np.sqrt(((ref[:, None, :] - prog[None, :, :]) ** 2).sum(-1))
    nearest = d.argmin(1)
    if len(np.unique(nearest)) != len(ref):
        return math.inf
    return _nan_inf(float(d[np.arange(len(ref)), nearest].max()))
