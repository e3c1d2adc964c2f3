"""Metrics logging: a JSONL event stream and the Python logger.

A copy of ``fp8_quantization_tpu/utils/metrics.py`` (``MetricsLogger``; no
JAX in it, and the port imports nothing of the JAX package): each
``log(step, metrics)`` appends one JSON line to ``<log_dir>/metrics.jsonl``
(when a directory is given) and logs the metrics at INFO.  Under
torch.distributed (parallel/) rank 0 alone writes the file.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

from fp8_quantization_tpu_torch.parallel import multihost

log = logging.getLogger(__name__)


class MetricsLogger:
    """Append metric dicts to <dir>/metrics.jsonl (and the python logger)."""

    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run"):
        self.log_dir = log_dir
        self.run_name = run_name
        self._fh = None
        if log_dir and multihost.process_index() == 0:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = ""):
        payload = {"run": self.run_name, "step": int(step),
                   "time": time.time()}
        payload.update({f"{prefix}{k}": (float(v) if hasattr(v, "__float__")
                                         else v)
                        for k, v in metrics.items()})
        log.info("step %d: %s", step,
                 {k: v for k, v in payload.items()
                  if k not in ("run", "time")})
        if self._fh:
            self._fh.write(json.dumps(payload) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
