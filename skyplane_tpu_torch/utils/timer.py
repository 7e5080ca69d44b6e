"""Timing context manager (reference: skyplane/utils/timer.py)."""

from __future__ import annotations

import time
from typing import Optional


class Timer:
    def __init__(self, desc: Optional[str] = None, print_desc: bool = False):
        self.desc = desc
        self.print_desc = print_desc
        self.start: Optional[float] = None
        self.end: Optional[float] = None

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        if self.print_desc and self.desc:
            print(f"{self.desc}: {self.elapsed:.4f}s")

    @property
    def elapsed(self) -> float:
        if self.start is None:
            return 0.0
        return (self.end or time.perf_counter()) - self.start
