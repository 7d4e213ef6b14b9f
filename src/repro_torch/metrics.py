"""Tiny JSONL metrics logger for training runs — a copy of
``repro.metrics`` (the port imports nothing of the JAX package).

``Logger(path).log(step, **metrics)`` appends one JSON line per call
(``{"step", "t", …}``; a tensor, 0-d on any device, becomes its float) and
echoes ``k=v`` to stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class Logger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self.t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self.t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "t")
            print(kv, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
