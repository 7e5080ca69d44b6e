"""A device trace on the tracer's clock, and the host's account of the
device's idle time.

``torch.profiler`` stamps its events on the epoch clock (Kineto converts
CUPTI's device timestamps to it), the clock the tracer's spans start on
(``time.time_ns()``): a device operation and the host spans around it
compare without conversion. :func:`profile_device` traces this process's
device for a few seconds (the daemon's ``POST /api/v1/profile/device``);
:func:`idle_by_host` splits the device's idle time in that window by the
innermost source-side span open at each moment.

Nothing here loads at daemon start: the route imports this module, and
:func:`profile_device` imports torch's profiler.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

#: span categories of the source side: the sender operators and the device
#: batch runner (the receiver's spans of an in-process sink are left out)
SOURCE_CATS = ("sender", "device")
#: idle time when no chunk was in the source: before its POST, after its ack
NO_CHUNK = "no_chunk_in_source"
#: idle time while a chunk was in the source but none of its spans was open
#: (a frame waiting in the frame-ahead queue, a worker between stages)
BETWEEN_SPANS = "between_spans"
#: idle time of a window traced with the tracer off: nothing to attribute
TRACING_OFF = "tracing_off"


class ProfilerBusy(RuntimeError):
    """Another ``torch.profiler`` is running in this process."""


def profiler_running() -> bool:
    """A profiler runs somewhere in this process: the autograd profiler's
    module-wide flag (``_profiler_enabled()`` alone answers for the calling
    thread only, and a second profiler started beside one crashes torch)."""
    import torch
    import torch.autograd.profiler as autograd_profiler

    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False) or torch._C._autograd._profiler_enabled())


def device_ops(prof) -> List[list]:
    """``[name, start_ns, end_ns]`` of every device operation of a finished
    profile, on the epoch clock, in start order."""
    import torch

    start = prof.profiler.kineto_results.trace_start_ns()
    ops = [
        [e.name, start + round(e.time_range.start * 1000), start + round(e.time_range.end * 1000)]
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    ops.sort(key=lambda op: op[1])
    return ops


def busy_intervals(ops: Sequence[Sequence], t0_ns: int, t1_ns: int) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, clipped to the window."""
    out: List[List[int]] = []
    for _, start, end in sorted(ops, key=lambda op: op[1]):
        start, end = max(start, t0_ns), min(end, t1_ns)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def idle_by_host(ops: Sequence[Sequence], spans: Sequence[dict], t0_ns: int, t1_ns: int) -> Dict[str, float]:
    """Seconds of the window ``[t0_ns, t1_ns)`` in which no device operation
    ran, keyed by the innermost of ``spans`` open at the time: the deepest
    by parent links, the latest started among equals. With no span open the
    key is :data:`BETWEEN_SPANS` while some chunk was in the source (between
    the first start and the last end of its spans) and :data:`NO_CHUNK`
    otherwise.

    ``ops``: ``[name, start_ns, end_ns]``; ``spans``: dicts with ``name``,
    ``start_ns``, ``end_ns``, ``span_id``, ``parent_id`` and ``chunk_id``
    (:meth:`Tracer.span_records`)."""
    parents = {s["span_id"]: s["parent_id"] for s in spans}

    def depth(span_id: int) -> int:  # parent links up to a root (or a parent outside ``spans``)
        seen = set()
        while parents.get(span_id) in parents and span_id not in seen:
            seen.add(span_id)
            span_id = parents[span_id]
        return len(seen)

    extents: Dict[str, List[int]] = {}
    for s in spans:
        if s.get("chunk_id") is not None:
            ext = extents.setdefault(s["chunk_id"], [s["start_ns"], s["end_ns"]])
            ext[0], ext[1] = min(ext[0], s["start_ns"]), max(ext[1], s["end_ns"])
    # boundary events, ends before starts at one instant: (t, 0 end / 1 start, kind, payload)
    events = []
    for s in spans:
        if s["end_ns"] > s["start_ns"]:
            key = (depth(s["span_id"]), s["start_ns"], s["span_id"])
            events += [(s["start_ns"], 1, 0, key, s["name"]), (s["end_ns"], 0, 0, key, s["name"])]
    for start, end in extents.values():
        if end > start:
            events += [(start, 1, 1, None, None), (end, 0, 1, None, None)]
    events.sort(key=lambda e: (e[0], e[1]))
    times = [e[0] for e in events]

    idle, prev = [], t0_ns
    for start, end in busy_intervals(ops, t0_ns, t1_ns):
        if start > prev:
            idle.append((prev, start))
        prev = end
    if t1_ns > prev:
        idle.append((prev, t1_ns))

    out: Dict[str, float] = defaultdict(float)
    open_spans: Dict[tuple, str] = {}
    chunks_open = 0
    i = 0
    for a, b in idle:
        cuts = [a, *sorted(set(times[bisect.bisect_right(times, a) : bisect.bisect_left(times, b)])), b]
        for x, y in zip(cuts, cuts[1:]):
            while i < len(events) and events[i][0] <= x:
                _, opening, is_chunk, key, name = events[i]
                if is_chunk:
                    chunks_open += 1 if opening else -1
                elif opening:
                    open_spans[key] = name
                else:
                    open_spans.pop(key, None)
                i += 1
            if open_spans:
                label = open_spans[max(open_spans)]
            else:
                label = BETWEEN_SPANS if chunks_open > 0 else NO_CHUNK
            out[label] += (y - x) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_device(seconds: float, device, tracer) -> dict:
    """Trace ``device`` with ``torch.profiler`` (CUDA activity; CPU activity
    on a CPU device, which has no device operations) for ``seconds``, in
    this process. Returns the window on the epoch clock, its device
    operations, the tracer's spans that overlap it, the busy and idle
    seconds, ``idle_by_host`` over the source-side spans, and how long the
    profiler took to start (``profiler_start_s``: the window opens after
    it). Raises
    :class:`ProfilerBusy` when a profiler already runs in the process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if profiler_running():
        raise ProfilerBusy("a torch.profiler is already running in this process")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    asked = time.time_ns()
    prof.start()
    t0 = time.time_ns()
    try:
        time.sleep(seconds)
    finally:
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.time_ns()
        prof.stop()
    ops = device_ops(prof) if cuda else []
    spans = [s for s in tracer.span_records() if s["end_ns"] > t0 and s["start_ns"] < t1]
    busy_s = sum(b - a for a, b in busy_intervals(ops, t0, t1)) / 1e9
    window_s = (t1 - t0) / 1e9
    if tracer.enabled:
        idle = idle_by_host(ops, [s for s in spans if s["cat"] in SOURCE_CATS], t0, t1)
    else:
        idle = {TRACING_OFF: window_s - busy_s}
    return {
        "device": str(dev),
        "window_ns": [t0, t1],
        "profiler_start_s": (t0 - asked) / 1e9,
        "window_s": window_s,
        "busy_s": busy_s,
        "idle_s": window_s - busy_s,
        "trace_sample": tracer.sample,
        "idle_by_host": idle,
        "ops": ops,
        "spans": spans,
    }
