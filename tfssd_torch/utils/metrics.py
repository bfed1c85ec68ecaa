"""Structured metrics logging and step timing (port of the JAX package's
utils/metrics.py: MetricsLogger, its JSONL log only, as the machine with
the card has no TensorFlow for TensorBoard events; and StepTimer).

One JSON object per line: the scalars under their (prefixed) names, then
the step and the wall-clock time, so a scalar named "step" or "time"
cannot overwrite them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class MetricsLogger:
    """Append-only JSONL scalar log in `log_dir`/`filename`."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        rec = {f"{prefix}{k}": float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StepTimer:
    """Host-clock step times and their percentiles. Call `start()`, then
    `tick()` after each step has finished (its results synchronised); the
    first `skip` ticks (set-up, warm-up) are left out of `measured`."""

    def __init__(self, skip: int = 2):
        self.skip = skip
        self._times: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._times.append(dt)
        return dt

    @property
    def measured(self) -> List[float]:
        return self._times[self.skip:]

    def summary(self) -> Dict[str, float]:
        """steps, mean and p50 / p90 / p99 seconds of the measured ticks;
        {} before the first measured tick."""
        ts = np.asarray(self.measured)
        if ts.size == 0:
            return {}
        return {
            "steps": int(ts.size),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p90_s": float(np.percentile(ts, 90)),
            "p99_s": float(np.percentile(ts, 99)),
        }
