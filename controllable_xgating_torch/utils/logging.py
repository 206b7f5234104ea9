"""Structured logging: JSONL scalars plus stdout lines.

Counterpart of `controllable_xgating_tpu/utils/logging.py`: one JSON event
per line (`ts`, `step`, scalars), and optionally a TensorBoard mirror of
the numeric scalars through `torch.utils.tensorboard` (the JAX package
writes its mirror with tensorflow's summary writer).
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
    """Append-only JSONL event log; `echo` mirrors each event to stdout.

    `tensorboard_dir` also mirrors the numeric scalars to a TensorBoard
    event file there, through `torch.utils.tensorboard.SummaryWriter`.
    Where that does not import (no `tensorboard` package), the logger says
    "tensorboard unavailable" once and keeps the JSONL log only."""

    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tensorboard_dir: Optional[str] = None):
        self.echo = echo
        self._fh = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._log = get_logger()
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # tensorboard absent or broken -> JSONL only
                self._log.info("tensorboard unavailable (%s)", e)

    def log(self, step: int, **scalars: Any) -> None:
        event = {"ts": time.time(), "step": int(step), **scalars}
        if self._fh is not None:
            self._fh.write(json.dumps(event, default=float) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), int(step))
        if self.echo:
            body = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in scalars.items())
            self._log.info("step %d %s", step, body)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
