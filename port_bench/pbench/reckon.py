"""How many bytes a run writes, reckoned before it starts.

Every object passes through the fleet as files: the source file (written
in set-up), the source daemon's chunk store (``read_local``), and at each
sink the receiver's chunk file and the destination file. So a run writes
about ``(2 + 2 * sinks)`` times the bytes it moves, base objects included.
When the daemons stop, each sink's segment store (persistent by default)
writes the segments it holds: the base objects' and the window's literal
share (``store_share`` of a mix). Journals and logs come on top; the budget
leaves room for them, and each run prints what it wrote.
"""

from __future__ import annotations


def write_factor(cfg: dict) -> int:
    return 2 + 2 * cfg["sinks"]


def window_objects(cfg: dict, mix: dict, seconds: float) -> int:
    """The number of objects the window offers: for a mix at a fixed rate,
    the rate times the part of the window that offers (``offer_share``);
    for a mix sized by the disk budget, as many as fit beside the base
    objects."""
    if mix.get("rate_bytes_per_s"):
        return int(round(mix["rate_bytes_per_s"] * seconds * mix.get("offer_share", 1.0) / mix["object_bytes"]))
    n = 0
    while planned_writes(cfg, mix, n + 1) <= mix["disk_budget_bytes"]:
        n += 1
    return n


def planned_writes(cfg: dict, mix: dict, n_window: int) -> int:
    base, window = mix["base_objects"] * mix["object_bytes"], n_window * mix["object_bytes"]
    store = cfg["sinks"] * (base + mix["store_share"] * window)
    return int((base + window) * write_factor(cfg) + store)


def check_budget(cfg: dict, mix: dict, n_window: int) -> int:
    """The bytes the run will write; raises ValueError over the mix's budget
    or when the window would offer nothing."""
    if n_window < 1:
        raise ValueError("the window offers no object under this disk budget")
    total = planned_writes(cfg, mix, n_window)
    if total > mix["disk_budget_bytes"]:
        raise ValueError(f"the run would write {total} bytes, over the mix's budget of {mix['disk_budget_bytes']}")
    return total
