"""Structured metrics logging (port of the JAX package's
utils/metrics.py:MetricsLogger, its JSONL log only: the machine with the
card has no TensorFlow for TensorBoard events).

One JSON object per line: the scalars under their (prefixed) names, then
the step and the wall-clock time, so a scalar named "step" or "time"
cannot overwrite them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


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
