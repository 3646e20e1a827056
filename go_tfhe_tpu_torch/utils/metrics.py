"""Structured metrics emission: one JSON line per metric record
(port of ``go_tfhe_tpu/utils/metrics.py``, the same class and behaviour;
the port keeps its own copy so that it imports nothing of the JAX
package).

Usage:
    from go_tfhe_tpu_torch.utils.metrics import MetricsLogger
    m = MetricsLogger(path="run_metrics.jsonl")   # path optional
    m.emit("gate_bootstraps_per_sec", 7726.3, unit="bootstraps/s",
           profile="128bit_fast")
    ...
    m.summary()          # -> list of all records
    m.close()
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional


class MetricsLogger:
    """Collects and emits one-line JSON metric records, to a stream
    (stdout by default) and, with ``path``, appended to a file."""

    def __init__(self, path: Optional[str] = None, stream=None):
        self.records: List[Dict[str, Any]] = []
        self._stream = sys.stdout if stream is None else stream
        self._file = open(path, "a") if path else None

    def emit(self, metric: str, value, unit: str = "", **fields) -> dict:
        rec = {"metric": metric, "value": value}
        if unit:
            rec["unit"] = unit
        rec.update(fields)
        self.records.append(rec)
        line = json.dumps(rec)
        print(line, file=self._stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        return rec

    def emit_seconds(self, metric: str, seconds: float,
                     unit_count: float = 1.0, unit: str = "ms",
                     **fields) -> dict:
        """Convenience for timings: seconds -> ms (optionally per unit)."""
        return self.emit(metric, round(seconds * 1e3 / unit_count, 3),
                         unit=unit, **fields)

    def summary(self) -> List[Dict[str, Any]]:
        return list(self.records)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
