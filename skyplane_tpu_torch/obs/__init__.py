"""Observability layer: chunk-lifecycle tracing + unified metrics registry.

PRs 2-4 made the data path overlapped and concurrent, but each subsystem
reported its own siloed counter blob (``/profile/compression``,
``/profile/socket/sender``, ``/profile/decode``) with no way to follow ONE
chunk across layers. This package closes that gap (Dapper-style per-request
tracing, Sigelman et al. 2010):

  * :mod:`skyplane_tpu_torch.obs.tracer` — a sampling tracer whose spans record
    into per-thread sharded ring buffers (bounded memory, dropped-span
    counters, no locks on the hot path) and export as Chrome trace-event
    JSON that loads directly in Perfetto. Off by default
    (``SKYPLANE_TPU_TRACE_SAMPLE=0`` ⇒ no-op spans, near-zero overhead).
  * :mod:`skyplane_tpu_torch.obs.metrics` — a :class:`MetricsRegistry` that
    absorbs the existing DATAPATH/DECODE/SENDER_WIRE counter schemas behind
    one registry and adds native counters/gauges/histograms, rendered in
    Prometheus text exposition format (``GET /api/v1/metrics``).
  * :mod:`skyplane_tpu_torch.obs.events` — the flight recorder: a bounded,
    seq-numbered journal of fleet-level events (admission, failover, replan,
    fault firings, stream breaks, spill degradations) behind
    ``GET /api/v1/events?since=<seq>``.
  * :mod:`skyplane_tpu_torch.obs.collector` — the fleet TelemetryCollector:
    scrapes every live gateway's metrics/trace/events/cpu endpoints, merges
    them into one labelled registry, one multi-process Perfetto timeline and
    one ordered fleet event log, and derives the per-stage bottleneck
    attribution (``skyplane-tpu bottleneck`` / ``monitor``).

Correlation across the wire: the sender samples per chunk id
(deterministically), stamps :data:`ChunkFlags.TRACED` into the wire frame
header, and the receiver honors that flag — so one chunk's sender spans
(frame → send → ack) and receiver spans (decode → store → write) stitch into
one timeline keyed by the chunk id (docs/observability.md).
"""

from skyplane_tpu_torch.obs.critical_path import critical_path, fit_fixed_overhead
from skyplane_tpu_torch.obs.events import FlightRecorder, configure_recorder, event_epoch, get_recorder
from skyplane_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from skyplane_tpu_torch.obs.profiler import NOOP_PROFILER, StackProfiler, configure_profiler, get_profiler
from skyplane_tpu_torch.obs.timeline import PhaseClock, build_timeline, phase_span, render_waterfall, solve_timeline
from skyplane_tpu_torch.obs.tracer import NOOP_SPAN, Tracer, configure_tracer, get_tracer

# NOTE: skyplane_tpu_torch.obs.collector (the fleet TelemetryCollector) is imported
# explicitly by its users — it pulls the control client and has no place on
# gateway hot paths.

__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "NOOP_PROFILER",
    "NOOP_SPAN",
    "PhaseClock",
    "StackProfiler",
    "Tracer",
    "build_timeline",
    "configure_profiler",
    "configure_recorder",
    "configure_tracer",
    "critical_path",
    "event_epoch",
    "fit_fixed_overhead",
    "get_profiler",
    "get_recorder",
    "get_registry",
    "get_tracer",
    "phase_span",
    "render_waterfall",
    "solve_timeline",
]
