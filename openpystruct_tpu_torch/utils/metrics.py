"""Structured metrics (port of ``utils/metrics.py``).

The reference's observability is print() statements and wall-clock
time.time() pairs (OpenPyStruct_FNN_MultiCase.py:530,587-591,
OpenPyStruct_BeamOpt_training_SingleCore.py:252,266-269).  This module
upgrades that to a structured metrics logger with JSONL persistence and an
optional TensorBoard writer (``utils/tb_writer.py``, first-party, so no
tensorboard package is needed), while keeping the zero-dependency default.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from openpystruct_tpu_torch.utils.tb_writer import TBEventWriter


class MetricsLogger:
    """Append-only metrics: in-memory history + optional JSONL file +
    optional TensorBoard event file (one scalar per numeric metric of an
    entry logged with a ``step``).

    Usage::

        m = MetricsLogger(jsonl="run.metrics.jsonl")
        m.log(epoch=3, train_loss=0.12, val_loss=0.15)
    """

    def __init__(self, jsonl: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 stdout: bool = False):
        self.history = []
        self._jsonl_path = jsonl
        self._jsonl = open(jsonl, "a") if jsonl else None
        self._stdout = stdout
        self._tb = TBEventWriter(tensorboard_dir) if tensorboard_dir else None

    def log(self, step: Optional[int] = None, **metrics):
        entry = {"time": time.time(), **metrics}
        if step is not None:
            entry["step"] = step
        self.history.append(entry)
        if self._jsonl:
            self._jsonl.write(json.dumps(entry) + "\n")
            self._jsonl.flush()
        if self._stdout:
            parts = [f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in entry.items() if k != "time"]
            print(" | ".join(parts))
        if self._tb is not None and step is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.scalar(k, v, step)

    def column(self, key):
        return [e[key] for e in self.history if key in e]

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
