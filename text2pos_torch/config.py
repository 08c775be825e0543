"""Serving configuration: the fields of ``text2pos_tpu/config.py``
(``EvalConfig``) that serving, calibration and the map encode read."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ServeConfig:
    max_text_len: int = 64            # token cap for the joined query text
    max_hint_len: int = 16            # token cap for a single hint
    num_mentioned: int = 6            # hints per query
    pad_size: int = 16                # objects per cell
    top_k: Tuple[int, ...] = (1, 5, 10)
    threshs: Tuple[int, ...] = (5, 10, 15)   # meters
    pointnet_numpoints: int = 256     # points per resampled object
    coarse_max_objects: int = 28      # object slots per cell of the map bank
    seed: int = 0                     # draws of the map bank and its encode
