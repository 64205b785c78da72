"""Structured training metrics: console + JSONL file logger (a copy of
`repro/utils/logging.py`)."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    """Append-only JSONL metrics with optional console echo.

    Usage:
        log = MetricLogger("runs/exp1", echo_every=10)
        log.log(step=5, loss=2.31, nll=2.31)
        log.close()
    """

    def __init__(self, out_dir: Optional[str] = None, echo_every: int = 10,
                 run_name: str = "train"):
        self.echo_every = echo_every
        self._fh = None
        self._t0 = time.monotonic()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._path = os.path.join(out_dir, f"{run_name}.jsonl")
            self._fh = open(self._path, "a")

    def log(self, step: int, **metrics):
        rec = {"step": int(step),
               "wall_s": round(time.monotonic() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo_every and step % self.echo_every == 0:
            kv = "  ".join(f"{k} {v:.4f}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in rec.items()
                           if k not in ("step",))
            print(f"step {step:5d}  {kv}")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
