"""Sampling chunk-lifecycle tracer with per-thread ring buffers.

Design constraints (the hot paths this instruments move GB/s):

  * **Disabled means free.** With ``SKYPLANE_TPU_TRACE_SAMPLE`` unset/0 the
    tracer is a single attribute check: ``span()`` returns the shared
    :data:`NOOP_SPAN` singleton — no allocation, no clock read, no branch
    beyond ``if not enabled`` (zero-allocation asserted in tests).
  * **No locks on the record path.** Each thread records into its OWN ring
    buffer (``threading.local``); the tracer-wide registry of rings is only
    touched when a thread records its first span. A full ring overwrites the
    oldest slot and bumps a per-ring ``dropped`` counter — memory is bounded
    at ``capacity`` span tuples per thread, and truncation is accounted, not
    silent.
  * **Deterministic sampling.** The sample decision is a pure function of
    the chunk id (crc32 / 2^32 < rate), so the sender and any observer
    replaying the same ids agree on the sampled set, and re-running a
    transfer traces the same chunks.
  * **Cross-process correlation.** The sender stamps the TRACED wire-header
    flag for sampled chunks; receivers pass ``force=True`` so their spans
    for that chunk record regardless of the local rate. Exported events
    carry the chunk id in ``args`` — the correlation key across pids.
  * **One tree per chunk in each process.** Every span takes an id, unique
    in the process, and its parent's id: the innermost span open on its
    thread, or the id the caller hands over where the work crossed threads
    (``parent=``, carried on the chunk request, batch entry or decode
    task; never on the wire). A span given no chunk id takes the one of the
    span open around it, so a device batch's spans join the tree of the
    chunk whose worker ran them. Both ids ride in each event's ``args``.
  * **Counters at the spans' boundaries.** :meth:`Tracer.timed` times a
    stage into an always-on counter and, where the stage is traced, into
    its span from the same two clock reads: the counter is the sum of its
    spans' durations.
  * **One clock with the device.** Spans start on ``time.time_ns()``, the
    epoch clock ``torch.profiler`` stamps its events on, so a device trace
    and the spans line up without conversion (``obs/device_trace.py``).

Export is Chrome trace-event JSON (the ``traceEvents`` array form): complete
``"X"`` events for context-managed spans (they nest by containment on one
tid) and async ``"b"``/``"e"`` pairs for externally-timed durations like ack
lag, which overlap other work and must not pollute the synchronous track.
Load the file directly in https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from typing import List, Optional

SAMPLE_ENV = "SKYPLANE_TPU_TRACE_SAMPLE"
RING_ENV = "SKYPLANE_TPU_TRACE_RING"
DEFAULT_RING = 4096  # span slots per thread; ~100 B/slot -> bounded memory


class _NoopSpan:
    """Shared do-nothing span (tracing disabled / chunk not sampled)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class _Ring:
    """One thread's span ring: fixed capacity, overwrite-oldest, lock-free
    (only its owner thread writes; readers snapshot slot tuples, which are
    replaced atomically by reference).

    ``tid`` is a tracer-unique sequence number, NOT ``threading.get_ident()``:
    the OS recycles thread idents, and two rings sharing an exported (pid,
    tid) track would merge unrelated threads' spans and break per-track
    nesting. The owning thread's name+ident ride in a metadata event."""

    __slots__ = ("capacity", "buf", "n", "dropped", "tid", "owner", "label", "cur_id", "cur_trace")

    def __init__(self, capacity: int, tid: int, owner: threading.Thread):
        self.capacity = capacity
        self.buf: List[Optional[tuple]] = [None] * capacity
        self.n = 0  # total spans ever recorded by this thread
        self.dropped = 0
        self.tid = tid
        self.owner = owner  # for liveness-based retirement of dead rings
        self.label = f"{owner.name} ({owner.ident})"
        self.cur_id = 0  # the innermost span open on this thread (0: none)
        self.cur_trace = None  # and its chunk id

    def record(
        self, kind: str, name: str, cat: str, trace_id, t0_wall_ns: int, dur_ns: int, args, span_id: int, parent_id: int
    ) -> None:
        i = self.n
        self.n = i + 1
        if i >= self.capacity:
            self.dropped += 1
        self.buf[i % self.capacity] = (kind, name, cat, trace_id, t0_wall_ns, dur_ns, args, span_id, parent_id)

    def snapshot(self) -> List[tuple]:
        return [e for e in self.buf if e is not None]


class _Span:
    """Context-managed span: wall-clock ts at entry, perf-counter duration,
    recorded into the owning thread's ring at exit (a tuple store — the span
    record path does NO I/O and takes NO locks; see the
    ``blocking-io-in-span`` static-analysis rule). While open it is its
    thread's innermost span: spans opened inside it take it as parent."""

    __slots__ = (
        "_ring", "name", "cat", "trace_id", "args", "span_id", "parent_id", "add", "key", "_prev", "_t0_wall", "_t0"
    )

    def __init__(self, ring: _Ring, name: str, cat: str, trace_id, args, span_id: int, parent_id: Optional[int]):
        self._ring = ring
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.args = args
        self.span_id = span_id
        self.parent_id = parent_id
        self.add = None  # a counter the duration also goes to (Tracer.timed)

    def __enter__(self):
        ring = self._ring
        self._prev = (ring.cur_id, ring.cur_trace)
        if self.parent_id is None:
            self.parent_id = ring.cur_id
        if self.trace_id is None:
            self.trace_id = ring.cur_trace
        ring.cur_id, ring.cur_trace = self.span_id, self.trace_id
        self._t0_wall = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        ring = self._ring
        dur_ns = time.perf_counter_ns() - self._t0
        ring.record(
            "X", self.name, self.cat, self.trace_id, self._t0_wall, dur_ns, self.args, self.span_id, self.parent_id
        )
        ring.cur_id, ring.cur_trace = self._prev
        if self.add is not None:
            self.add(self.key, dur_ns)
        return False


class _Timer:
    """The counter half of :meth:`Tracer.timed` for a stage no span records:
    two clock reads and one add."""

    __slots__ = ("add", "key", "_t0")

    def __init__(self, add, key):
        self.add = add
        self.key = key

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.add(self.key, time.perf_counter_ns() - self._t0)
        return False


class Tracer:
    #: dead-thread rings retained for export (recently-finished workers'
    #: spans stay visible); beyond this, the OLDEST dead rings retire and
    #: only their totals survive — total tracer memory stays bounded at
    #: (live threads + MAX_DEAD_RINGS) x capacity even under the gateway's
    #: per-connection thread churn
    MAX_DEAD_RINGS = 64
    #: span ids, unique in the process across tracer instances (``next`` on
    #: a count is atomic under the interpreter lock)
    _span_ids = itertools.count(1)

    def __init__(self, sample: float = 0.0, capacity: int = DEFAULT_RING, label: str = "skyplane-tpu"):
        self.sample = max(0.0, min(1.0, float(sample)))
        self.enabled = self.sample > 0.0
        self.capacity = max(16, int(capacity))
        self.label = label
        self._tls = threading.local()
        self._rings: List[_Ring] = []
        self._rings_lock = threading.Lock()  # cold path: first span per thread
        self._tid_seq = 0
        self._retired_recorded = 0  # totals from retired dead-thread rings
        self._retired_dropped = 0

    # ---- sampling ----

    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-id decision: same id -> same verdict, in every
        process, at the same rate (crc32(id)/2^32 < rate)."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 4294967296.0 < self.sample

    # ---- recording ----

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            with self._rings_lock:
                self._tid_seq += 1
                ring = _Ring(self.capacity, self._tid_seq, threading.current_thread())
                self._rings.append(ring)
                self._retire_dead_rings_locked()
            self._tls.ring = ring
        return ring

    def _retire_dead_rings_locked(self) -> None:
        """Bound memory under thread churn: keep the newest MAX_DEAD_RINGS
        rings whose owner thread has exited, fold older ones into the
        retired totals. Runs only on new-ring registration (cold path)."""
        dead = [r for r in self._rings if not r.owner.is_alive()]
        for ring in dead[: max(0, len(dead) - self.MAX_DEAD_RINGS)]:
            self._retired_recorded += ring.n
            self._retired_dropped += ring.dropped
            self._rings.remove(ring)

    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        cat: str = "",
        args=None,
        force: bool = False,
        parent: Optional[int] = None,
    ):
        """A context-managed span. ``trace_id`` (the chunk id) keys sampling
        AND correlation; ``trace_id=None`` spans (device batches, spill I/O)
        record whenever tracing is enabled, under the chunk id of the span
        open around them. ``force=True`` bypasses the local sample decision
        — the receiver path for wire-flagged chunks. ``parent`` is the id of
        a span on another thread that caused this one (default: the
        innermost span open on this thread)."""
        if not self.enabled:
            return NOOP_SPAN
        if trace_id is not None and not force and not self.sampled(trace_id):
            return NOOP_SPAN
        return _Span(self._ring(), name, cat, trace_id, args, next(self._span_ids), parent or None)

    def timed(
        self,
        name: str,
        add,
        key,
        trace_id: Optional[str] = None,
        cat: str = "",
        args=None,
        force: bool = False,
    ):
        """A stage timed into an always-on counter: ``add(key, ns)`` gets its
        duration whether or not it is traced (``key`` is passed through: a
        counter's name, or what else the adder needs). Where :meth:`span` would record
        (same arguments, same decision) the span and the counter share one
        pair of clock reads, so the counter sums its spans' durations
        exactly; elsewhere only the counter's two clock reads are paid."""
        span = self.span(name, trace_id=trace_id, cat=cat, args=args, force=force)
        if span is NOOP_SPAN:
            return _Timer(add, key)
        span.add, span.key = add, key
        return span

    def current_span_id(self) -> int:
        """The innermost span open on this thread (0: none, or tracing off),
        for handing over to the thread the work moves to."""
        if not self.enabled:
            return 0
        ring = getattr(self._tls, "ring", None)
        return ring.cur_id if ring is not None else 0

    def record_span(
        self,
        name: str,
        dur_ns: int,
        t0_wall_ns: int,
        trace_id: Optional[str] = None,
        cat: str = "",
        args=None,
        force: bool = False,
        parent: Optional[int] = None,
    ) -> int:
        """Record an externally-timed duration (ack lag, device wait) as an
        ASYNC event pair — these overlap other work on the same thread, so
        they get their own track instead of breaking "X"-span nesting.
        Parent and chunk id default as in :meth:`span`. Returns the span's
        id (0 when nothing was recorded), for spans it caused."""
        if not self.enabled:
            return 0
        if trace_id is not None and not force and not self.sampled(trace_id):
            return 0
        ring = self._ring()
        span_id = next(self._span_ids)
        ring.record(
            "b",
            name,
            cat,
            trace_id if trace_id is not None else ring.cur_trace,
            t0_wall_ns,
            dur_ns,
            args,
            span_id,
            parent or ring.cur_id,
        )
        return span_id

    # ---- export / accounting ----

    def counters(self) -> dict:
        with self._rings_lock:
            rings = list(self._rings)
            retired_recorded, retired_dropped = self._retired_recorded, self._retired_dropped
        return {
            "trace_sample": self.sample,
            "spans_recorded": retired_recorded + sum(r.n for r in rings),
            "spans_dropped": retired_dropped + sum(r.dropped for r in rings),
            "spans_buffered": sum(min(r.n, r.capacity) for r in rings),
            "trace_threads": len(rings),
        }

    def span_records(self) -> List[dict]:
        """Every buffered span on the epoch clock: ``name``, ``cat``,
        ``chunk_id``, ``start_ns``, ``end_ns``, ``span_id``, ``parent_id``
        (0 for a root) and ``async`` (a :meth:`record_span` record)."""
        with self._rings_lock:
            rings = list(self._rings)
        return [
            {
                "name": name,
                "cat": cat,
                "chunk_id": trace_id,
                "start_ns": t0_wall,
                "end_ns": t0_wall + dur_ns,
                "span_id": span_id,
                "parent_id": parent_id,
                "async": kind != "X",
            }
            for ring in rings
            for kind, name, cat, trace_id, t0_wall, dur_ns, _args, span_id, parent_id in ring.snapshot()
        ]

    def export(self) -> dict:
        """Chrome trace-event JSON (dict form: ``json.dump`` it and open in
        Perfetto). "X" spans keep their thread's tid; async records become
        "b"/"e" pairs keyed by (name, trace_id). Each span's ``args`` hold
        its ``span_id`` and ``parent_id`` (None for a root)."""
        pid = os.getpid()
        events = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": self.label}},
        ]
        with self._rings_lock:
            rings = list(self._rings)
        for ring in rings:
            events.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": ring.tid, "args": {"name": ring.label}}
            )
            for kind, name, cat, trace_id, t0_wall, dur_ns, args, span_id, parent_id in ring.snapshot():
                ev_args = dict(args) if args else {}
                if trace_id is not None:
                    ev_args["chunk_id"] = trace_id
                ev_args["span_id"] = span_id
                ev_args["parent_id"] = parent_id or None
                base = {
                    "name": name,
                    "cat": cat or "span",
                    "pid": pid,
                    "tid": ring.tid,
                    "ts": t0_wall / 1000.0,  # Chrome ts/dur are microseconds
                    "args": ev_args,
                }
                if kind == "X":
                    base["ph"] = "X"
                    base["dur"] = dur_ns / 1000.0
                    events.append(base)
                else:  # async pair
                    # the id is a pure function of the record, NOT an export
                    # counter: a collector scraping this cumulative endpoint
                    # twice must get the SAME pair ids both times, or its
                    # union-dedupe would double every async event
                    aid = f"{trace_id or 'span'}:{name}:{ring.tid}:{t0_wall}:{dur_ns}"
                    ev_args["dur_us"] = dur_ns / 1000.0  # pair duration, for trace-derived stats
                    events.append({**base, "ph": "b", "id": aid})
                    events.append(
                        {
                            "name": name,
                            "cat": cat or "span",
                            "pid": pid,
                            "tid": ring.tid,
                            "ts": (t0_wall + dur_ns) / 1000.0,
                            "ph": "e",
                            "id": aid,
                            "args": {},
                        }
                    )
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tracer": self.label, **self.counters()},
        }

    def reset(self) -> None:
        """Drop every recorded span (tests / bench rep isolation). Rings stay
        registered — their owner threads keep writing into fresh slots."""
        with self._rings_lock:
            rings = list(self._rings)
            self._retired_recorded = self._retired_dropped = 0
        for ring in rings:
            ring.buf = [None] * ring.capacity
            ring.n = 0
            ring.dropped = 0


# ---- process-wide singleton ----

_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def _from_env() -> Tracer:
    raw = os.environ.get(SAMPLE_ENV, "0")
    try:
        sample = float(raw or 0)
    except ValueError:
        from skyplane_tpu_torch.utils.logger import logger

        logger.fs.warning(f"ignoring malformed {SAMPLE_ENV}={raw!r}; tracing stays off")
        sample = 0.0
    try:
        capacity = int(os.environ.get(RING_ENV, str(DEFAULT_RING)))
    except ValueError:
        capacity = DEFAULT_RING
    return Tracer(sample=sample, capacity=capacity)


def get_tracer() -> Tracer:
    global _tracer
    t = _tracer
    if t is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = _from_env()
            t = _tracer
    return t


def configure_tracer(
    sample: Optional[float] = None, capacity: Optional[int] = None, label: Optional[str] = None
) -> Tracer:
    """Replace the process tracer (tests, bench passes, CLI overrides).
    ``sample=None`` re-reads the environment."""
    global _tracer
    with _tracer_lock:
        base = _from_env()
        _tracer = Tracer(
            sample=base.sample if sample is None else sample,
            capacity=base.capacity if capacity is None else capacity,
            label=label if label is not None else base.label,
        )
        return _tracer
