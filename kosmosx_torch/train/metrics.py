"""Structured training metrics (counterpart of
kosmosx_tpu/train/metrics.py:21-62).

``MetricsLogger`` is a ``Trainer.run`` ``log_fn``: each call writes one
JSONL record ``{"step", "time", **metrics}`` (tensors and numbers as
floats), logs the floats to the console, and sends the record to wandb
when ``use_wandb`` is set and ``wandb`` imports.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 use_wandb: bool = False, project: str = "kosmosx_torch",
                 config: Optional[Dict[str, Any]] = None,
                 console: bool = True):
        self.console = console
        self._file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, config=config or {})
            except Exception as e:
                logger.info("wandb unavailable (%s); skipping", type(e).__name__)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": step, "time": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "item") or
                           isinstance(v, (int, float)) else v)
                       for k, v in metrics.items()})
        if self._file:
            self._file.write(json.dumps(record) + "\n")
        if self._wandb:
            self._wandb.log(record, step=step)
        if self.console:
            short = {k: round(v, 5) for k, v in record.items()
                     if isinstance(v, float)}
            logger.info("step %d %s", step, short)

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        self.log(step, metrics)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
