"""Structured scalar metrics (jsonl), replacing the reference's ad-hoc
text series (WriteVectorToFile, Debug.H:360-378) and stdout monitors
(PrintDensityFluctuation, Debug.H:210-228); a copy of
``bflbm_tpu/io/metrics.py``."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, step: int, **values: Any) -> Dict[str, Any]:
        rec = {"step": int(step), "t_wall": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in values.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
