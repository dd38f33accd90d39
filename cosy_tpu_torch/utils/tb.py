"""TensorBoard scalar output (the port's copy of the JAX package's
``utils/tb.py``; reference train_utils.py:187-192 writes TB summaries on
rank 0).

The writer is import-gated: without the tensorboard package it is a no-op
and the metrics stream stays the record.  Scalars come from values already
on the host.  One process, so there is no rank check.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class TBWriter:
    """TensorBoard scalar writer with a no-op fallback."""

    def __init__(self, logdir: Optional[str], enabled: bool = True):
        self._w = None
        if not (enabled and logdir):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(logdir, exist_ok=True)
            self._w = SummaryWriter(logdir)
        except ImportError:  # tensorboard is optional
            self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def add_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "train") -> None:
        if self._w is None:
            return
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self._w.add_scalar(f"{prefix}/{k}", float(v), int(step))

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def jsonl_to_tb(jsonl_path: str, logdir: str) -> int:
    """Convert a metrics.jsonl into TB event files; each line's ``step`` (or
    ``epoch``) is its global step.  Returns the records written."""
    w = TBWriter(logdir)
    n = 0
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = int(rec.get("step", rec.get("epoch", n)))
            w.add_scalars(step, {k: v for k, v in rec.items() if k not in ("step", "epoch")})
            n += 1
    w.flush()
    w.close()
    return n
