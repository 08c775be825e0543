"""Structured metric logging and debugging switches (counterpart of
``text2pos_tpu/utils/profiling.py``): ``MetricsLogger`` appends one JSON
record a call (``T2P_METRICS_JSONL`` in the trainers); ``enable_nan_tripwire``
is ``torch.autograd.set_detect_anomaly`` (``T2P_DEBUG_NANS``). Device time is
read with ``torch.profiler`` over the ``record_function`` ranges that the
modules and trainers mark (``train.forward``, ``train.backward``,
``train.optimizer``, ``pointnet.*``, ``serve.*``)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metric log: one record per call."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: Dict) -> None:
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **record}) + "\n")


def enable_nan_tripwire() -> None:
    """Make a NaN produced in a backward pass raise with the forward's
    traceback."""
    torch.autograd.set_detect_anomaly(True)
