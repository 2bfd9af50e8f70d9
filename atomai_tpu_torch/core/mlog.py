"""Training-metrics log, one JSON object per line (counterpart of
`atomai_tpu/core/mlog.py:20-55`).

``fit(..., metrics_log="run.jsonl")`` appends, per epoch::

    {"cycle": 17, "wall_s": 12.93, "train_elbo": ..., "test_elbo": ...}

Lines are flushed as they are written, so ``tail -f`` follows a live run.
"""

import json
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metric stream; one object per training cycle."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, cycle: int, **metrics) -> None:
        rec = {"cycle": int(cycle),
               "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            if v is not None:
                rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def open_metrics_log(path: Optional[str]) -> Optional[MetricsLogger]:
    return MetricsLogger(path) if path else None
