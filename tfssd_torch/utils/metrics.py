"""Structured metrics logging and step timing (port of the JAX package's
utils/metrics.py: MetricsLogger and StepTimer).

MetricsLogger writes one JSON object per line: the scalars under their
(prefixed) names, then the step and the wall-clock time, so a scalar named
"step" or "time" cannot overwrite them. Beside it, where `tensorboard`
(the default), each scalar goes into a TensorBoard event file in the same
directory, as the JAX package's tf.summary writer does, written without
TensorFlow (utils/tfevents.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from tfssd_torch.utils.tfevents import EventFileWriter


class MetricsLogger:
    """Append-only JSONL scalar log in `log_dir`/`filename`, and where
    `tensorboard` a new TensorBoard event file in `log_dir` holding the same
    scalars (float32, tagged by their prefixed names), flushed at each
    log() as the JSONL is line-buffered. A write that fails raises."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                self._tb = EventFileWriter(log_dir)
            except BaseException:
                self._f.close()
                raise

    @property
    def events_path(self) -> Optional[str]:
        return None if self._tb is None else self._tb.path

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        rec = {f"{prefix}{k}": float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.scalar(f"{prefix}{k}", float(v), int(step),
                                rec["time"])
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

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
