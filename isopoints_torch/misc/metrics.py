"""Scalar metrics as an append-only JSONL stream (port of
isopoints_tpu/misc/metrics.py): one object {"it", "ts", ...} per call."""

import json
import os
import time
from typing import Dict, List


class MetricsWriter:
    """Append-only JSONL scalar logger; values `float()` refuses are
    skipped."""

    def __init__(self, out_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self.history: List[Dict[str, float]] = []

    def log(self, it: int, metrics: Dict[str, float], prefix: str = "") -> None:
        row = {"it": int(it), "ts": time.time()}
        for k, v in metrics.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        self.history.append(row)

    def close(self) -> None:
        self._f.close()


def load_metrics(path: str) -> List[Dict[str, float]]:
    """Read a metrics.jsonl back into a list of dicts."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
