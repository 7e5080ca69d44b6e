"""Shared retry machinery: jittered exponential backoff with deadlines.

``retry_backoff`` keeps its historical signature (reference:
skyplane/utils/retry.py:10-37) and gains three recovery-contract parameters
(docs/fault-injection.md):

  * ``jitter`` — fraction of each backoff randomized (0 = the old exact
    exponential). Synchronized retries from a fleet of workers hammering a
    just-recovered endpoint re-fail together; jitter decorrelates them.
  * ``deadline_s`` — total wall-clock budget across all attempts. A retry
    loop with attempts but no deadline can stall a worker for minutes when
    backoffs compound; the deadline re-raises the last error on time.
  * ``retry_if`` — predicate refining WHICH caught exceptions retry (e.g.
    retry HTTP 5xx but not 4xx within one exception class).

:class:`RetryPolicy` is the reusable form: one frozen policy object per call
site class (reconnects, control POSTs, token releases), shared by the sender
wire engine, the serial sender path, dispatch, and the fair-share scheduler —
replacing the scattered flat ``time.sleep(0.2)`` loops the
``flat-sleep-in-retry-loop`` lint rule now rejects.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type, TypeVar

from skyplane_tpu_torch.utils.logger import logger

R = TypeVar("R")


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff, bounded by attempts AND wall clock.

    ``backoff_s(attempt)`` for attempt 0,1,2,... returns
    ``base * 2**attempt`` capped at ``max_backoff``, with the top ``jitter``
    fraction uniformly randomized — so concurrent retriers spread out instead
    of re-colliding. ``call(fn)`` runs the full loop.
    """

    max_attempts: int = 8
    initial_backoff: float = 0.1
    max_backoff: float = 8.0
    jitter: float = 0.5  # 0 = deterministic, 1 = fully randomized backoff
    deadline_s: Optional[float] = None
    exception_class: Tuple[Type[BaseException], ...] = (Exception,)
    retry_if: Optional[Callable[[BaseException], bool]] = None

    def backoff_s(self, attempt: int) -> float:
        base = min(self.initial_backoff * (2 ** max(0, attempt)), self.max_backoff)
        j = min(1.0, max(0.0, self.jitter))
        if j <= 0:
            return base
        return base * (1 - j) + base * j * random.random()

    def call(
        self,
        fn: Callable[[], R],
        log_errors: bool = True,
        abort_check: Optional[Callable[[], bool]] = None,
    ) -> R:
        """Run ``fn`` under this policy. Non-retryable exceptions (wrong
        class, or ``retry_if`` says no) propagate immediately; exhausting
        attempts or the deadline re-raises the last retryable error.
        ``abort_check`` returning True (daemon shutdown) also re-raises
        immediately instead of sleeping into a dead process."""
        deadline = time.monotonic() + self.deadline_s if self.deadline_s is not None else None
        attempts = max(1, int(self.max_attempts))
        for attempt in range(attempts):
            try:
                return fn()
            except self.exception_class as e:
                if self.retry_if is not None and not self.retry_if(e):
                    raise
                if attempt == attempts - 1:
                    raise
                if abort_check is not None and abort_check():
                    raise
                sleep_s = self.backoff_s(attempt)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    sleep_s = min(sleep_s, remaining)
                if log_errors:
                    name = getattr(fn, "__name__", str(fn))
                    logger.fs.warning(
                        f"retry: {name} failed (attempt {attempt + 1}/{attempts}, "
                        f"backoff {sleep_s:.2f}s): {e}"
                    )
                time.sleep(sleep_s)
        raise RuntimeError("unreachable")


def retry_backoff(
    fn: Callable[[], R],
    max_retries: int = 8,
    initial_backoff: float = 0.1,
    max_backoff: float = 8.0,
    exception_class: Tuple[Type[BaseException], ...] = (Exception,),
    log_errors: bool = True,
    jitter: float = 0.0,
    deadline_s: Optional[float] = None,
    retry_if: Optional[Callable[[BaseException], bool]] = None,
) -> R:
    """Historical entry point; defaults reproduce the original exact
    exponential loop. New call sites should prefer a shared RetryPolicy."""
    return RetryPolicy(
        max_attempts=max_retries,
        initial_backoff=initial_backoff,
        max_backoff=max_backoff,
        jitter=jitter,
        deadline_s=deadline_s,
        exception_class=exception_class,
        retry_if=retry_if,
    ).call(fn, log_errors=log_errors)
