"""Training metrics as JSON lines, with a stdout echo.

The port's own copy of ``unified_audio_tpu/utils/logging.py``:
``MetricsLogger`` appends one JSON object a record (``step``, the wall
seconds since the logger opened, then the metrics) to a file and prints
it.
"""
from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        rec.update({
            k: (float(v) if hasattr(v, "item") or isinstance(v, float) else v)
            for k, v in metrics.items()
        })
        line = json.dumps(rec)
        print(line, flush=True)
        self._fh.write(line + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
