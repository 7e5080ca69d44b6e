"""The readers of the program's stage timings: nanosecond counters at the
boundaries of its spans, as a mean in ms per unit of work. A program without
such a counter (an older commit) leaves it out of its snapshots; the metric
then reads None, not 0."""

from __future__ import annotations

from typing import Optional

from pbench import readers


def ms_per(run, group: str, key: str, per: str) -> Optional[float]:
    if key not in run.after.get(group, {}):
        return None
    return readers.ratio(run.delta(group, key), run.delta(group, per), 1e-6)
