"""Flight recorder: a bounded, seq-numbered structured event journal.

PRs 6-8 grew a set of fleet-level *events* — admission 429s, gateway
failover, replan decisions, fault firings, circuit-breaker stream breaks,
spill degradations — that were scattered across tracker attributes
(``failover_events``), injector firing logs, and log lines. None of them
were queryable as one ordered record. The flight recorder is that record:

  * every event is a small dict ``{"seq", "ts", "kind", ...fields}`` with a
    process-monotonic sequence number, appended to a bounded ring
    (``SKYPLANE_TPU_EVENT_LOG`` entries, default 4096; overwrite-oldest with
    a ``events_dropped`` counter — memory is bounded, truncation is never
    silent, matching the tracer/profile-queue conventions);
  * gateways expose it at ``GET /api/v1/events?since=<seq>`` so a collector
    can tail incrementally (the ``since`` cursor makes repeat scrapes cheap
    and idempotent);
  * the recorder mints a ``recorder_id`` so a collector that scrapes several
    gateways sharing one process (the in-process loopback harness) can
    de-duplicate by ``(recorder_id, seq)`` instead of triple-counting.

Recording sites are all COLD paths (admission decisions, socket resets,
fault firings, transfer lifecycle transitions) — a lock per record is fine;
nothing here may be called per chunk on the data path.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional

EVENT_LOG_ENV = "SKYPLANE_TPU_EVENT_LOG"
DEFAULT_EVENT_LOG = 4096

# well-known event kinds (free-form kinds are allowed; these are the ones the
# subsystems emit and docs/observability.md documents)
EV_DISPATCH_START = "transfer.dispatch_start"
EV_DISPATCH_END = "transfer.dispatch_end"
EV_TRANSFER_COMPLETE = "transfer.complete"
EV_TRANSFER_ERROR = "transfer.error"
EV_ADMISSION_GRANTED = "admission.granted"
EV_ADMISSION_REJECTED = "admission.rejected"
EV_JOB_RELEASED = "job.released"
EV_GATEWAY_DEAD = "failover.gateway_dead"
EV_REPLAN = "replan.decision"
EV_REPLAN_APPLIED = "replan.applied"
# capacity-repair loop (docs/provisioning.md "Repair & drain"): graceful spot
# drain on the gateway side, replacement provisioning on the tracker side
EV_DRAIN_START = "drain.start"
EV_DRAIN_COMPLETE = "drain.complete"
EV_DRAIN_OBSERVED = "drain.observed"  # tracker noticed a gateway DRAINING
EV_REPLACEMENT_REQUESTED = "replacement.requested"
EV_REPLACEMENT_READY = "replacement.ready"
EV_REPLACEMENT_FAILED = "replacement.failed"
EV_FAULT_FIRED = "fault.fired"
# planner fallback visibility (docs/blast.md): an overlay/blast planner that
# could not (or chose not to) build its preferred topology records WHY —
# paired with the skyplane_planner_downgrades_total counter so a blast job
# can assert it really got a relay tree instead of a silent direct fan-out
EV_PLANNER_DOWNGRADE = "planner.downgrade"
# checkpoint-blast fan-out (skyplane_tpu/blast, docs/blast.md): per-sink
# completion + tree-healing lifecycle
EV_BLAST_SINK_COMPLETE = "blast.sink_complete"
EV_BLAST_RELAY_DEAD = "blast.relay_dead"
EV_BLAST_RETARGETED = "blast.retargeted"
EV_BLAST_REQUEUED = "blast.requeued"
EV_PUMP_WORKER_DEATH = "pump.worker_death"  # multi-process pump worker died (respawn follows)
EV_STREAM_RESET = "stream.reset"
EV_STREAM_BREAK = "stream.break"
EV_STREAM_REVIVE = "stream.revive"
EV_SPILL_DEGRADED = "spill.degraded"
# job lifecycle phases (obs/timeline.py PhaseClock, docs/observability.md
# "Job timelines & critical path"): each phase is a pair of
# ``phase.<name>`` events with ``edge="start"`` / ``edge="end"`` plus a
# shared ``phase_id`` so the timeline builder can pair them even when several
# recorders interleave. The phase names mirror the fixed-overhead ledger the
# 2.5× campaign (ROADMAP item 4) is chasing.
PH_PLAN = "phase.plan"
PH_PROVISION = "phase.provision"
PH_CRED_STAGE = "phase.cred_stage"
PH_GATEWAY_BOOT = "phase.gateway_boot"
PH_FIRST_COMPILE = "phase.first_compile"
PH_POOL_WARM = "phase.pool_warm"
PH_DISPATCH = "phase.dispatch"
PH_DRAIN = "phase.drain"
PH_TEARDOWN = "phase.teardown"
ALL_PHASES = (
    PH_PLAN,
    PH_PROVISION,
    PH_CRED_STAGE,
    PH_GATEWAY_BOOT,
    PH_FIRST_COMPILE,
    PH_POOL_WARM,
    PH_DISPATCH,
    PH_DRAIN,
    PH_TEARDOWN,
)


def event_epoch(ev: dict) -> float:
    """Best epoch timestamp for one recorded event: the anchored monotonic
    reading (``anchor + mono``) when both fields are numeric, else the raw
    wall-clock ``ts``. The anchored form keeps one recorder's events ordered
    even when that host's wall clock steps mid-run — the collector merge and
    the timeline builder both key on it."""
    mono = ev.get("mono")
    anchor = ev.get("anchor")
    if isinstance(mono, (int, float)) and isinstance(anchor, (int, float)):
        return float(anchor) + float(mono)
    ts = ev.get("ts", 0.0)
    return float(ts) if isinstance(ts, (int, float)) else 0.0


class FlightRecorder:
    """Bounded, seq-ordered journal of structured events (see module doc)."""

    def __init__(self, capacity: int = DEFAULT_EVENT_LOG, recorder_id: Optional[str] = None):
        self.capacity = max(16, int(capacity))
        # identifies THIS journal across scrapes: several gateway APIs in one
        # process share one recorder, several processes never share an id
        self.recorder_id = recorder_id or uuid.uuid4().hex[:16]
        # monotonic epoch anchor: wall-clock epoch at recorder birth minus the
        # monotonic reading at the same instant. ``anchor + mono`` reconstructs
        # an epoch timestamp that is immune to wall-clock steps (NTP slews,
        # VM suspend/restore) WITHIN one recorder — the collector's merge
        # prefers it over ``ts`` so cross-process timelines don't reorder when
        # a host's wall clock drifts mid-transfer (docs/observability.md).
        self.mono_anchor = time.time() - time.monotonic()
        self._lock = threading.Lock()
        self._events: "deque[dict]" = deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields) -> int:
        """Append one event; returns its sequence number. Cold paths only."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            if len(self._events) >= self.capacity:
                self._dropped += 1  # deque(maxlen) evicts the oldest below
            event = {
                "seq": seq,
                "ts": time.time(),
                "mono": time.monotonic(),
                "anchor": self.mono_anchor,
                "kind": kind,
            }
            event.update(fields)
            self._events.append(event)
        return seq

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def events_since(self, since: int = 0, limit: Optional[int] = None) -> List[dict]:
        """Events with ``seq > since`` in seq order (the tail-cursor query
        behind ``GET /api/v1/events?since=``)."""
        with self._lock:
            out = [dict(e) for e in self._events if e["seq"] > since]
        if limit is not None:
            out = out[: max(0, int(limit))]
        return out

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "events_recorded": self._seq,
                "events_dropped": self._dropped,
                "events_buffered": len(self._events),
            }

    def reset(self) -> None:
        """Drop every buffered event and restart numbering (test isolation)."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped = 0


# ---- process-wide singleton ----

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def _from_env() -> FlightRecorder:
    try:
        capacity = int(os.environ.get(EVENT_LOG_ENV, str(DEFAULT_EVENT_LOG)))
    except ValueError:
        capacity = DEFAULT_EVENT_LOG
    return FlightRecorder(capacity=capacity)


def get_recorder() -> FlightRecorder:
    global _recorder
    rec = _recorder
    if rec is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = _from_env()
            rec = _recorder
    return rec


def configure_recorder(capacity: Optional[int] = None) -> FlightRecorder:
    """Replace the process recorder (tests / smoke isolation); ``None``
    re-reads the environment for the capacity."""
    global _recorder
    with _recorder_lock:
        _recorder = _from_env() if capacity is None else FlightRecorder(capacity=capacity)
        return _recorder
