"""Structured logging: JSONL scalars plus stdout lines.

Counterpart of `controllable_xgating_tpu/utils/logging.py`, without its
TensorBoard mirror: one JSON event per line (`ts`, `step`, scalars).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Optional


def get_logger(name: str = "cxg") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class JsonlLogger:
    """Append-only JSONL event log; `echo` mirrors each event to stdout."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._log = get_logger()

    def log(self, step: int, **scalars: Any) -> None:
        event = {"ts": time.time(), "step": int(step), **scalars}
        if self._fh is not None:
            self._fh.write(json.dumps(event, default=float) + "\n")
        if self.echo:
            body = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in scalars.items())
            self._log.info("step %d %s", step, body)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
