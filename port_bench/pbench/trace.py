"""Reduction of the window's torch.profiler trace: device busy time (the
union of every device operation's interval), time by operation name, idle
gaps, and a kernel's roofline share from its bytes.

Peaks: NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet: 3.35 TB/s of
HBM bandwidth. Every kernel of the served path is bound by bytes, so a
roofline share here counts bytes only: each input byte read once and each
output byte written once, whatever implements the kernel.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

PEAK_BYTES_PER_S = 3.35e12

# the CUDA functions of each kernel of the served path, as the trace names them
KERNEL_FUNCTIONS = {
    "gear_compact": ("gear_compact_kernel",),
    "segment_fp": ("segment_fp_kernel", "segment_fp_finalize_kernel"),
}


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device operation in a profile."""
    import torch

    return [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _merged(events: List[Tuple[str, float, float]]) -> List[Tuple[float, float, str]]:
    """Busy intervals (start, end, name of the operation that opened it)."""
    out: List[List] = []
    for name, start, end in sorted(events, key=lambda e: e[1]):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end, name])
    return [tuple(iv) for iv in out]


def busy_us(events) -> float:
    return sum(end - start for start, end, _ in _merged(events))


def by_name_s(events) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for name, start, end in events:
        out[name] += (end - start) / 1e6
    return dict(out)


def idle_gaps_s(events, window_us: float) -> Dict[str, float]:
    """Idle device time between busy intervals, by the operation that ended
    the gap ("before <op>"); the gap after the last operation is "window end"."""
    out: Dict[str, float] = defaultdict(float)
    prev_end = 0.0
    for start, end, name in _merged(events):
        if start > prev_end:
            out[f"before {name}"] += (start - prev_end) / 1e6
        prev_end = max(prev_end, end)
    if window_us > prev_end:
        out["window end"] += (window_us - prev_end) / 1e6
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def kernel_seconds(events, kernel: str) -> float:
    """Device seconds of a kernel's functions, matched as whole identifiers
    in the traced name (``segment_fp_kernel`` is not ``segment_fp_fixed_...``)."""
    pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(KERNEL_FUNCTIONS[kernel]) + r")(?![A-Za-z0-9_])")
    return sum(end - start for name, start, end in events if pattern.search(name)) / 1e6


def roofline_pct(n_bytes: float, seconds: float):
    """Share of the bytes bound: bytes at peak bandwidth over the time taken."""
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * (n_bytes / PEAK_BYTES_PER_S) / seconds
