"""Per-step metrics as JSON lines (the port's copy of
mhada_tpu/utils/profiling.py::MetricsLogger)."""

import json
import time


class MetricsLogger:
    """Append one JSON object per ``log`` call to ``path`` (None: return the
    row only)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, **extra) -> dict:
        row = {"step": step, "time": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}, **extra}
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
