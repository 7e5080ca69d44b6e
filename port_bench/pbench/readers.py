"""Reductions shared by the metric readers in ``port_bench/metrics/``.

Each counter is taken as its change across the window, never its total
since the daemons started: the set-up traffic also passed through them.
A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""

from __future__ import annotations

from typing import Optional

from pbench import stats, trace


def ratio(num: float, den: float, scale: float = 1.0) -> Optional[float]:
    return num / den * scale if den else None


def goodput_gbps(run) -> Optional[float]:
    g = stats.goodput_gbps(run.sizes, run.done_at_close, run.seconds)
    return g or None


def wire_reduction(run) -> Optional[float]:
    """Raw bytes of the window's chunks, once per stream, over the bytes the
    loopback link carried from the window's start until every one of them
    had landed: frames, TLS, TCP and IP headers, acks, whatever path the
    program sends them by."""
    return ratio(sum(run.sizes) * run.spec.cfg["sinks"], run.wire_bytes)


def device_wait_ms_per_chunk(run) -> Optional[float]:
    return ratio(run.delta("sender", "device_wait_ns"), run.delta("sender", "chunks"), 1e-6)


def rows_per_window(run) -> Optional[float]:
    return ratio(run.delta("runner", "batch_rows"), run.delta("runner", "batch_windows"))


def ref_share_pct(run) -> Optional[float]:
    return ratio(run.delta("sender", "ref_segments"), run.delta("sender", "segments"), 100.0)


def ack_lag_ms_per_frame(run) -> Optional[float]:
    return ratio(run.delta("wire", "ack_lag_ns"), run.delta("wire", "frames_sent"), 1e-6)


def decode_ms_per_chunk(run) -> Optional[float]:
    return ratio(run.delta("decode", "decode_ns"), run.delta("decode", "decode_chunks"), 1e-6)


def idle_pct(run) -> Optional[float]:
    if not run.events or run.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us(run.events) / run.window_us)


# bytes each kernel needs per segment besides its rows (read once): K-AB
# writes each cut candidate's position (int32; the segments' ends stand for
# the candidates, a lower bound), K-C writes each segment's eight u32 lanes
KERNEL_OUT_BYTES_PER_SEGMENT = {"gear_compact": 4, "segment_fp": 32}


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    """Bytes bound over traced time of a kernel in the window: every chunk a
    source stream encoded went through it once (rows read once, outputs
    written once)."""
    if not run.events:
        return None
    n_bytes = run.delta("sender", "raw_bytes") + KERNEL_OUT_BYTES_PER_SEGMENT[kernel] * run.delta("sender", "segments")
    return trace.roofline_pct(n_bytes, trace.kernel_seconds(run.events, kernel))
