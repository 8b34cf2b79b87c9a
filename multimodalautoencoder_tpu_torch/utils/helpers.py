"""Small helpers the sweeps need.

A copy of ``multimodalautoencoder_tpu/utils/helpers.py`` (reference:
helper_funcs.py), kept here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# substring -> friendly name (helper_funcs.py:17-31)
_FRIENDLY = (("happiness", "happiness"), ("happy", "happiness"),
             ("health", "health"), ("calm", "calmness"),
             ("stress", "stress"), ("energy", "energy"))


def get_secs_mins_hours_from_secs(total_secs: float
                                  ) -> Tuple[int, int, int]:
    """seconds -> (hours, mins, secs) (helper_funcs.py:1-15)."""
    total_secs = int(total_secs)
    hours = total_secs // 3600
    mins = (total_secs % 3600) // 60
    secs = total_secs % 60
    return hours, mins, secs


def get_rmse(x, y) -> float:
    """Root mean squared error between two arrays, in float64
    (multimodal_autoencoder.py:1218-1220)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return float(np.sqrt(np.mean((x - y) ** 2)))


def get_friendly_label_name(label_col: str) -> str:
    """Long label column -> short name via substring match
    (helper_funcs.py:17-31); falls back to the column name itself."""
    low = label_col.lower()
    for sub, name in _FRIENDLY:
        if sub in low:
            return name
    return label_col.replace("_label", "")
