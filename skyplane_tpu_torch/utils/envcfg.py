"""Tolerant env-var parsing for config knobs.

One canonical pair: a malformed value (operator typo in a knob) falls back
to the default instead of crashing a daemon/tracker at startup. New call
sites import from here rather than growing more per-module copies.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default
