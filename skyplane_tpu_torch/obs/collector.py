"""Fleet telemetry collector: one merged view of many gateways' signals.

Until this module, every observability surface was per-process: to see a
transfer you scraped ``/api/v1/metrics`` and ``/api/v1/trace`` gateway by
gateway by hand, spans stitched across exactly one sender↔receiver hop, and
the fleet-level events PRs 6-8 added lived in scattered tracker attributes.
The :class:`TelemetryCollector` closes that gap:

  * **Scrape**: every live gateway's ``/metrics``, ``/trace``, ``/events``
    and ``/profile/cpu`` endpoints, in parallel, each request under its own
    timeout — a dead or hanging gateway is marked *stale* after
    ``stale_after`` consecutive failures and NEVER blocks the poll (or the
    tracker loop the collector rides along with); it rejoins automatically
    on the first successful scrape.
  * **Merge — metrics**: per-gateway Prometheus samples re-rendered as one
    fleet exposition with ``gateway``/``region``/``provider`` labels.
  * **Merge — traces**: one multi-process Perfetto timeline. Events carry
    ``args.gateway`` (stamped at span creation, docs/observability.md), so
    the merger can regroup them under one synthetic pid per gateway — true
    per-gateway rows even when several in-process harness gateways share one
    OS pid and one tracer. Because ``/api/v1/trace`` is cumulative, merging
    is a union with exact-duplicate elimination; dedupe keys on the event
    identity (name/phase/origin pid/tid/ts/dur/id/chunk), which also makes
    scraping N co-located gateways that share a tracer return each span once.
  * **Tail — events**: the flight recorder journals (obs/events.py) tail via
    the ``?since=<seq>`` cursor, de-duplicated by ``(recorder_id, seq)``,
    ordered into one fleet log and appended to a JSONL file per transfer for
    post-mortems.
  * **Attribute — bottleneck**: the per-stage latency breakdown (frame /
    send-stall / ack-lag / decode / store / device-wait) plus per-thread CPU
    time aggregate into a per-transfer "where did the time go" report
    (``skyplane-tpu bottleneck``; ROADMAP items 1 and 5's stated harness).
"""

from __future__ import annotations

import json
import re
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from skyplane_tpu_torch.obs.events import event_epoch
from skyplane_tpu_torch.utils.logger import logger

#: stage -> span name, shared by bench.py's ``stage_latency_us`` and the
#: bottleneck report so the two are the same arithmetic over the same spans
#: (the acceptance criterion: they reconcile within 10%)
STAGE_SPANS = {
    "frame": "wire.frame",
    "send_stall": "wire.send_stall",
    "ack_lag": "wire.ack_lag",
    "decode": "decode",
    "store": "store.write",
    "device_wait": "batch.device_wait",
}
BOTTLENECK_STAGES = tuple(STAGE_SPANS)
_SPAN_TO_STAGE = {v: k for k, v in STAGE_SPANS.items()}

# value matched loosely (any non-space token) and validated by float() at the
# parse site: a char-class would silently drop legitimate renderings like
# '1.5e-05' (negative exponent) or 'NaN'
_PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")

#: a gateway is "single-core-bound" when its process effectively uses no more
#: than this many cores while demand is visible (GIL wait, or the one core
#: near saturation) — the verdict ROADMAP item 1's multi-core pump is judged
#: against (docs/benchmark.md "single-core ceiling")
SINGLE_CORE_CEILING = 1.25
#: GIL wait above this fraction marks contention as the reason threads fail
#: to scale (vs genuinely idle)
GIL_BOUND_FRACTION = 0.2


# --------------------------------------------------------------- attribution


def _event_dur_us(ev: dict) -> Optional[float]:
    """The duration of one trace event in microseconds: ``dur`` for complete
    ("X") spans, ``args.dur_us`` for async begin markers, None otherwise."""
    ph = ev.get("ph")
    if ph == "X":
        dur = ev.get("dur")
        return float(dur) if isinstance(dur, (int, float)) else None
    if ph == "b":
        dur = (ev.get("args") or {}).get("dur_us")
        return float(dur) if isinstance(dur, (int, float)) else None
    return None


def stage_breakdown(events: Sequence[dict]) -> Dict[str, dict]:
    """Per-stage totals over a trace-event list: every stage key is always
    present (zeros when a stage never ran) with ``count``/``total_us``/
    ``mean_us``. bench.py's ``stage_latency_us`` is exactly the ``mean_us``
    column of this table."""
    out = {stage: {"count": 0, "total_us": 0.0, "mean_us": 0.0} for stage in BOTTLENECK_STAGES}
    for ev in events:
        stage = _SPAN_TO_STAGE.get(ev.get("name"))
        if stage is None:
            continue
        dur = _event_dur_us(ev)
        if dur is None:
            continue
        row = out[stage]
        row["count"] += 1
        row["total_us"] += dur
    for row in out.values():
        row["total_us"] = round(row["total_us"], 3)
        row["mean_us"] = round(row["total_us"] / row["count"], 3) if row["count"] else 0.0
    return out


def core_budget(summary: Optional[dict]) -> Optional[dict]:
    """One gateway's core-time budget from a profiler ``summary()`` payload
    (obs/profiler.py): cores effectively used, GIL-wait fraction, the top-5
    stages by CPU seconds, and the single-core-bound verdict. ``None`` when
    the profiler is off or has no samples yet (graceful on old gateways)."""
    if not isinstance(summary, dict) or not summary.get("samples"):
        return None
    stage_cpu = summary.get("stage_cpu_s") or {}
    top = sorted(((s, v) for s, v in stage_cpu.items() if v > 0), key=lambda kv: -kv[1])[:5]
    cores = float(summary.get("cores_effective") or 0.0)
    gil = float(summary.get("gil_wait_fraction") or 0.0)
    # single-core-bound = the process cannot use a second core: it burns at
    # most ~one core AND either threads visibly serialize on the GIL or that
    # one core is near saturation (a mostly-idle process is I/O-bound, not
    # core-bound — adding cores would not help either, but for a different,
    # non-actionable reason, so the verdict stays False)
    single = cores <= SINGLE_CORE_CEILING and (gil >= GIL_BOUND_FRACTION or cores >= 0.75)
    return {
        "cores_effective": cores,
        "gil_wait_fraction": gil,
        "gil_wait_expected": float(summary.get("gil_wait_expected") or 0.0),
        "runnable_threads": float(summary.get("runnable_threads") or 0.0),
        "top_stages": [{"stage": s, "cpu_s": round(v, 4)} for s, v in top],
        "single_core_bound": bool(single),
        "samples": int(summary.get("samples") or 0),
        "samples_dropped": int(summary.get("samples_dropped") or 0),
        "cpu_clock": summary.get("cpu_clock") or "task",
    }


def bottleneck_report(
    merged_trace: dict,
    cpu_profiles: Optional[Dict[str, dict]] = None,
    profile_summaries: Optional[Dict[str, dict]] = None,
) -> dict:
    """The per-transfer "where did the time go" attribution: fleet-wide and
    per-gateway stage breakdowns from a (merged) trace, plus per-gateway
    per-thread CPU seconds when ``/profile/cpu`` scrapes are supplied
    (``{gateway_id: cpu_payload}``) and the core-budget table when sampling
    profiles are (``{gateway_id: profiler summary}``)."""
    events = merged_trace.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") in ("X", "b")]
    # a merged timeline already assigned every event a per-gateway pid; use
    # that for spans that carry no args.gateway of their own (fault markers,
    # device-batch spans)
    pid_to_gateway = {
        pid: gw for gw, pid in ((merged_trace.get("otherData") or {}).get("gateway_pids") or {}).items()
    }
    by_gateway: Dict[str, List[dict]] = {}
    for ev in spans:
        gw = (ev.get("args") or {}).get("gateway") or pid_to_gateway.get(ev.get("pid")) or "?"
        by_gateway.setdefault(gw, []).append(ev)
    chunk_ids = {(e.get("args") or {}).get("chunk_id") for e in spans}
    chunk_ids.discard(None)
    per_gateway = {}
    # profile summaries may cover gateways whose spans never reached this
    # trace (sampling off / trace ring overwritten): the core-budget table
    # must still show them, so union the two key sets
    all_gateways = set(by_gateway) | set(profile_summaries or {})
    for gw in sorted(all_gateways):
        evs = by_gateway.get(gw, [])
        entry = {"stages": stage_breakdown(evs), "spans": len(evs)}
        cpu = (cpu_profiles or {}).get(gw)
        if cpu:
            threads = cpu.get("threads") or {}
            entry["cpu_s"] = {name: info.get("cpu_s", 0.0) for name, info in sorted(threads.items())}
            entry["cpu_total_s"] = round(sum(entry["cpu_s"].values()), 6)
        budget = core_budget((profile_summaries or {}).get(gw))
        if budget is not None:
            entry["core_budget"] = budget
        per_gateway[gw] = entry
    return {
        "stages": stage_breakdown(spans),
        "per_gateway": per_gateway,
        "n_gateways": len(by_gateway),
        "n_spans": len(spans),
        "n_chunks": len(chunk_ids),
    }


def format_bottleneck(report: dict) -> str:
    """Human table for ``skyplane-tpu bottleneck``: one row per stage, one
    block per gateway, CPU attribution when available."""
    lines = [
        f"bottleneck attribution: {report['n_spans']} spans, {report['n_chunks']} chunks, "
        f"{report['n_gateways']} gateway(s)",
        "",
        f"{'stage':<12} {'count':>7} {'total_ms':>10} {'mean_us':>10}",
    ]
    for stage in BOTTLENECK_STAGES:
        row = report["stages"][stage]
        lines.append(f"{stage:<12} {row['count']:>7} {row['total_us'] / 1000.0:>10.2f} {row['mean_us']:>10.1f}")
    for gw, entry in report["per_gateway"].items():
        lines.append("")
        lines.append(f"gateway {gw}: {entry['spans']} spans")
        for stage in BOTTLENECK_STAGES:
            row = entry["stages"][stage]
            if row["count"]:
                lines.append(
                    f"  {stage:<12} {row['count']:>7} {row['total_us'] / 1000.0:>10.2f}ms {row['mean_us']:>9.1f}us"
                )
        cpu = entry.get("cpu_s")
        if cpu:
            lines.append(f"  thread cpu ({entry.get('cpu_total_s', 0.0):.3f}s total):")
            for name, s in sorted(cpu.items(), key=lambda kv: -kv[1])[:12]:
                lines.append(f"    {name:<28} {s:>9.3f}s")
        budget = entry.get("core_budget")
        if budget:
            verdict = "YES" if budget["single_core_bound"] else "no"
            lines.append(
                f"  core budget: {budget['cores_effective']:.2f} cores used, "
                f"GIL wait {100.0 * budget['gil_wait_fraction']:.1f}%, "
                f"single-core-bound: {verdict}"
                + (f" ({budget['samples_dropped']} samples dropped)" if budget["samples_dropped"] else "")
            )
            if budget["top_stages"]:
                tops = ", ".join(f"{r['stage']} {r['cpu_s']:.3f}s" for r in budget["top_stages"])
                lines.append(f"    top CPU stages: {tops}")
    return "\n".join(lines)


def cpu_gil_cells(
    cpu_payload: Optional[dict],
    prev_cpu_s: Optional[float],
    dt_s: float,
    profile_summary: Optional[dict],
) -> Tuple[str, str, Optional[float]]:
    """The ``skyplane-tpu monitor`` CPU%/GIL-wait% cells for one gateway row:
    ``(cpu_cell, gil_cell, process_cpu_s_now)``. CPU% is the process-CPU
    delta between scrapes over the scrape interval (may exceed 100% — that's
    cores); GIL% comes from the profiler summary. Either source missing (old
    gateway 404, profiler off, first scrape) renders a graceful ``—``."""
    cpu_cell, cpu_now = "—", None
    if isinstance(cpu_payload, dict) and isinstance(cpu_payload.get("process_cpu_s"), (int, float)):
        cpu_now = float(cpu_payload["process_cpu_s"])
        if prev_cpu_s is not None and dt_s > 0:
            cpu_cell = f"{100.0 * max(0.0, cpu_now - prev_cpu_s) / dt_s:.0f}%"
    gil_cell = "—"
    if isinstance(profile_summary, dict) and profile_summary.get("samples"):
        gil_cell = f"{100.0 * float(profile_summary.get('gil_wait_fraction') or 0.0):.0f}%"
    return cpu_cell, gil_cell, cpu_now


# ------------------------------------------------------------- trace merging


def _event_identity(ev: dict) -> tuple:
    """Identity of one trace event for union-dedupe across scrapes: the
    originating (pid, tid) plus timing and name pin the record; chunk id and
    async id disambiguate same-name same-ts events."""
    args = ev.get("args") or {}
    return (
        ev.get("name"),
        ev.get("ph"),
        ev.get("pid"),
        ev.get("tid"),
        ev.get("ts"),
        ev.get("dur"),
        ev.get("id"),
        args.get("chunk_id"),
        args.get("gateway"),
    )


def merge_traces(scrapes: Sequence[Tuple[dict, dict]]) -> dict:
    """Merge per-gateway trace exports into ONE multi-process timeline.

    ``scrapes`` is ``[(gateway_meta, export_dict), ...]`` where gateway_meta
    carries ``gateway`` (id) and optionally ``region``/``provider``. Events
    are unioned with exact-duplicate elimination (cumulative endpoint +
    co-located gateways sharing a tracer), then REGROUPED under one synthetic
    pid per gateway: an event belongs to ``args.gateway`` when the span
    stamped it (the per-span identity that survives shared-process harnesses)
    and to the scraped gateway otherwise. Process rows sort by the minimum
    hop index seen on the gateway's spans, so Perfetto shows source → relay →
    destination top to bottom."""
    seen: set = set()
    deduped: List[Tuple[str, dict]] = []  # (scrape gateway, event)
    meta_by_gateway: Dict[str, dict] = {}
    # async "e" end markers carry no args (by design — the pair's payload
    # rides the "b"): they must land on the SAME synthetic pid as their "b"
    # or every pair unbalances. Keyed by the ORIGIN (pid, id).
    async_home: Dict[tuple, str] = {}
    for meta, export in scrapes:
        scrape_gw = str(meta.get("gateway") or "?")
        meta_by_gateway.setdefault(scrape_gw, dict(meta))
        for ev in export.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue  # metadata is re-synthesized per merged process row
            key = _event_identity(ev)
            if key in seen:
                continue
            seen.add(key)
            deduped.append((scrape_gw, ev))
            if ev.get("ph") == "b":
                gw = str((ev.get("args") or {}).get("gateway") or scrape_gw)
                async_home.setdefault((ev.get("pid"), ev.get("id")), gw)
    per_gateway: Dict[str, List[dict]] = {}
    min_hop: Dict[str, int] = {}
    first_ts: Dict[str, float] = {}
    for scrape_gw, ev in deduped:
        args = ev.get("args") or {}
        if ev.get("ph") == "e":
            gw = async_home.get((ev.get("pid"), ev.get("id")), scrape_gw)
        else:
            gw = str(args.get("gateway") or scrape_gw)
        meta_by_gateway.setdefault(gw, {"gateway": gw})
        per_gateway.setdefault(gw, []).append(ev)
        hop = args.get("hop")
        if isinstance(hop, int):
            min_hop[gw] = min(min_hop.get(gw, hop), hop)
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            first_ts[gw] = min(first_ts.get(gw, ts), ts)

    def sort_key(gw: str):
        return (min_hop.get(gw, 1 << 30), first_ts.get(gw, float("inf")), gw)

    ordered = sorted(per_gateway, key=sort_key)
    merged: List[dict] = []
    gateway_pids: Dict[str, int] = {}
    for row, gw in enumerate(ordered):
        pid = 1000 + row
        gateway_pids[gw] = pid
        meta = meta_by_gateway.get(gw, {})
        label = gw
        if meta.get("region"):
            label = f"{gw} ({meta['region']})"
        merged.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": label}})
        merged.append({"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0, "args": {"sort_index": row}})
        tid_labels = {}
        for ev in per_gateway[gw]:
            out = dict(ev)
            out["pid"] = pid
            merged.append(out)
            tid_labels.setdefault(ev.get("tid"), None)
        for tid in tid_labels:
            merged.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": f"{gw} tid {tid}"}}
            )
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": [meta_by_gateway.get(gw, {"gateway": gw}) for gw in ordered],
            "gateway_pids": gateway_pids,
        },
    }


# ------------------------------------------------------------ metrics merging


def parse_prometheus(text: str) -> List[Tuple[str, str, float]]:
    """Parse Prometheus text exposition into ``(name, label_block, value)``
    samples (label_block keeps its braces, '' when absent). HELP/TYPE lines
    and malformed values are skipped — scraping must tolerate partial junk."""
    out: List[Tuple[str, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        out.append((m.group(1), m.group(2) or "", value))
    return out


def render_fleet_metrics(per_gateway: Dict[str, Tuple[dict, str]]) -> str:
    """One fleet-level exposition from per-gateway scrapes: every sample
    re-rendered with ``gateway``/``region``/``provider`` labels prepended.
    ``per_gateway`` maps gateway_id -> (meta, prometheus_text)."""
    from skyplane_tpu_torch.obs.metrics import _fmt

    families: Dict[str, List[str]] = {}
    for gw_id in sorted(per_gateway):
        meta, text = per_gateway[gw_id]
        extra = [f'gateway="{gw_id}"']
        for key in ("region", "provider"):
            if meta.get(key):
                extra.append(f'{key}="{meta[key]}"')
        extra_block = ",".join(extra)
        for name, labels, value in parse_prometheus(text):
            inner = labels[1:-1] if labels else ""
            joined = f"{extra_block},{inner}" if inner else extra_block
            # _fmt renders integers EXACTLY ('%g' would quantize byte
            # counters past 6 significant digits and zero out scrape deltas)
            families.setdefault(name, []).append(f"{name}{{{joined}}} {_fmt(value)}")
    lines: List[str] = []
    for name in sorted(families):
        lines.append(f"# HELP {name} fleet-merged from per-gateway scrapes")
        lines.append(f"# TYPE {name} gauge")
        lines.extend(families[name])
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------- collector


def api_base_of(url: str) -> str:
    """Normalize an operator-supplied gateway control URL to its ``/api/v1``
    base (the one place the control-API base path is known — the CLI
    commands and one-shot scrapers all route through here)."""
    base = url.rstrip("/")
    if not base.endswith("/api/v1"):
        base = f"{base}/api/v1"
    return base


class GatewayTarget:
    """One scrapeable gateway: control URL base (``.../api/v1``), identity
    labels, and a session factory (so TLS contexts/tokens ride along)."""

    def __init__(
        self,
        gateway_id: str,
        api_base: str,
        *,
        region: str = "",
        provider: str = "",
        session_fn: Optional[Callable] = None,
    ):
        self.gateway_id = gateway_id
        self.api_base = api_base.rstrip("/")
        self.region = region
        self.provider = provider or (region.split(":", 1)[0] if region else "")
        self._session_fn = session_fn
        self._session = None

    def meta(self) -> dict:
        return {"gateway": self.gateway_id, "region": self.region, "provider": self.provider}

    def session(self):
        # cached: the collector scrapes every interval forever — a fresh
        # Session per wave would re-handshake TCP/TLS four times per gateway
        # per poll and dominate the collector's own overhead budget
        if self._session is None:
            if self._session_fn is not None:
                self._session = self._session_fn()
            else:
                from skyplane_tpu_torch.gateway.control_auth import control_session

                self._session = control_session()
        return self._session

    @staticmethod
    def from_bound_gateway(bound) -> "GatewayTarget":
        """Adapt the tracker's BoundGateway (api/dataplane.py) surface."""
        region = getattr(bound, "region_tag", "") or ""
        return GatewayTarget(
            bound.gateway_id,
            bound.control_url(),
            region=region,
            session_fn=bound.control_session,
        )


class _TargetState:
    __slots__ = (
        "target",
        "consec_failures",
        "stale",
        "events_since",
        "metrics_text",
        "trace",
        "cpu",
        "profile",
        "recoveries",
        "combined",
    )

    def __init__(self, target: GatewayTarget):
        self.target = target
        self.consec_failures = 0
        self.stale = False
        self.events_since = 0  # tail cursor into the gateway's flight recorder
        self.metrics_text: Optional[str] = None
        self.trace: Optional[dict] = None
        self.cpu: Optional[dict] = None
        self.profile: Optional[dict] = None  # sampling-profiler summary (core budget)
        self.recoveries = 0
        self.combined = True  # /api/v1/telemetry supported (cleared on 404)


class TelemetryCollector:
    """Periodic fleet scraper (see module docstring). Runs on its OWN daemon
    thread (``start()``/``stop()``) so a slow scrape can never stall the
    tracker's completion-poll loop; ``poll_once()`` is also callable directly
    (CLI one-shots, tests, the monitor smoke)."""

    def __init__(
        self,
        targets: Sequence[GatewayTarget],
        *,
        poll_interval_s: Optional[float] = None,
        scrape_timeout_s: Optional[float] = None,
        stale_after: int = 2,
        fleet_log_path: Optional[str] = None,
        exclude_fn: Optional[Callable[[], set]] = None,
        local_recorder=None,
        label: str = "fleet",
        cpu_every: int = 5,
    ):
        from skyplane_tpu_torch.utils.envcfg import env_float

        self.poll_interval_s = (
            poll_interval_s if poll_interval_s is not None else env_float("SKYPLANE_TPU_COLLECT_INTERVAL_S", 2.0)
        )
        self.scrape_timeout_s = (
            scrape_timeout_s if scrape_timeout_s is not None else env_float("SKYPLANE_TPU_COLLECT_TIMEOUT_S", 5.0)
        )
        self.stale_after = max(1, int(stale_after))
        self.label = label
        # per-thread CPU clocks move slowly relative to the poll cadence:
        # scraping them every Nth wave keeps the attribution fresh enough
        # while trimming a quarter of the collector's per-cycle request cost
        self.cpu_every = max(1, int(cpu_every))
        # a gateway the control plane already declared dead (PR-8 failover)
        # is excluded BEFORE the scrape: its timeouts must not slow the wave
        self.exclude_fn = exclude_fn or (lambda: set())
        # the collector's own process may hold a flight recorder too (the
        # tracker's lifecycle/failover/replan events): tail it locally so the
        # fleet log is complete without scraping ourselves over HTTP
        self.local_recorder = local_recorder
        self._local_since = 0
        self._states = {t.gateway_id: _TargetState(t) for t in targets}
        self._lock = threading.Lock()
        # fleet event log: bounded in memory (the JSONL file is the durable
        # record); (recorder_id, seq) dedupe because co-located gateways share
        # one recorder
        from collections import deque

        self._events: "deque[dict]" = deque(maxlen=65536)
        self._events_seen: set = set()
        self._counters = {
            "collector_polls": 0,
            "collector_scrapes": 0,
            "collector_scrape_failures": 0,
            "collector_events_tailed": 0,
            "collector_recoveries": 0,
        }
        self.fleet_log_path = fleet_log_path
        self._log_fh = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def add_target(self, target: GatewayTarget) -> bool:
        """Adopt a gateway mid-run (a replacement provisioned by the repair
        loop, docs/provisioning.md): it joins the next scrape wave. Returns
        False when the id is already tracked (idempotent)."""
        with self._lock:
            if target.gateway_id in self._states:
                return False
            self._states[target.gateway_id] = _TargetState(target)
        return True

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name=f"telemetry-collector-{self.label}", daemon=True)
        self._thread.start()

    def stop(self, final_poll: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.scrape_timeout_s * 2 + 1.0)
            self._thread = None
        if final_poll:
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - telemetry must never fail a transfer
                logger.fs.warning(f"[collector] final poll failed: {e}")
        with self._lock:
            fh, self._log_fh = self._log_fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - a bad poll must not kill the loop
                logger.fs.warning(f"[collector] poll failed: {e}")
            self._stop.wait(self.poll_interval_s)

    # ---- scraping ----

    def poll_once(self) -> dict:
        """One scrape wave over all non-excluded targets (parallel, each
        request individually timed out). Returns per-gateway ok/stale flags."""
        from skyplane_tpu_torch.utils import do_parallel

        excluded = set(self.exclude_fn() or ())
        with self._lock:
            states = [s for s in self._states.values() if s.target.gateway_id not in excluded]
            self._counters["collector_polls"] += 1
            # first and every cpu_every-th wave refresh the CPU clocks; the
            # stop() final poll (run after the thread exits) lands on a fresh
            # count often enough that post-mortems see an endgame snapshot
            want_cpu = (self._counters["collector_polls"] - 1) % self.cpu_every == 0
        results = (
            dict(do_parallel(lambda s: self._scrape_target(s, want_cpu), states, n=16)) if states else {}
        )
        self._tail_local_recorder()
        return {s.target.gateway_id: ok for s, ok in results.items()}

    def _scrape_target(self, state: _TargetState, want_cpu: bool = True) -> bool:
        t = state.target
        try:
            session = t.session()
            timeout = self.scrape_timeout_s
            metrics_text = trace_payload = events_payload = cpu_payload = profile_payload = None
            if state.combined:
                # ONE round trip per gateway per wave (GET /api/v1/telemetry):
                # per-request HTTP machinery costs more CPU than the payloads,
                # and the <2% collector budget is spent on round trips
                resp = session.get(
                    f"{t.api_base}/telemetry",
                    params={
                        "since": str(state.events_since),
                        "cpu": "1" if want_cpu else "0",
                        # the profiler summary rides the CPU cadence: both
                        # answer "where do the cores go" and move slowly
                        "profile": "1" if want_cpu else "0",
                    },
                    timeout=timeout,
                )
                if resp.status_code == 404:
                    state.combined = False  # older gateway: per-endpoint fallback below
                else:
                    resp.raise_for_status()
                    payload = resp.json()
                    metrics_text = payload.get("metrics_text")
                    trace_payload = payload.get("trace")
                    events_payload = payload.get("events") or {}
                    cpu_payload = payload.get("cpu")
                    profile_payload = payload.get("profile")
            if metrics_text is None:
                metrics = session.get(f"{t.api_base}/metrics", timeout=timeout)
                metrics.raise_for_status()
                metrics_text = metrics.text
                trace = session.get(f"{t.api_base}/trace", timeout=timeout)
                trace.raise_for_status()
                trace_payload = trace.json()
                events = session.get(
                    f"{t.api_base}/events", params={"since": str(state.events_since)}, timeout=timeout
                )
                events.raise_for_status()
                events_payload = events.json()
                if want_cpu:
                    try:
                        cpu = session.get(f"{t.api_base}/profile/cpu", timeout=timeout)
                        if cpu.ok:
                            cpu_payload = cpu.json()
                    except Exception:  # noqa: BLE001 - cpu profile is additive, never gating
                        pass
                    try:
                        # summary-only form: old gateways 404 here and the
                        # scrape stays whole — core-budget columns render "—"
                        stacks = session.get(
                            f"{t.api_base}/profile/stacks", params={"summary": "1"}, timeout=timeout
                        )
                        if stacks.ok:
                            profile_payload = (stacks.json() or {}).get("summary")
                    except Exception:  # noqa: BLE001 - profiler summary is additive, never gating
                        pass
        except Exception as e:  # noqa: BLE001 - any scrape failure is a liveness signal, not a crash
            with self._lock:
                state.consec_failures += 1
                self._counters["collector_scrape_failures"] += 1
                if state.consec_failures >= self.stale_after and not state.stale:
                    state.stale = True
                    logger.fs.warning(
                        f"[collector] gateway {t.gateway_id} stale after {state.consec_failures} failed scrapes: {e}"
                    )
            return False
        with self._lock:
            if state.stale:
                state.recoveries += 1
                self._counters["collector_recoveries"] += 1
                logger.fs.info(f"[collector] gateway {t.gateway_id} recovered")
            state.stale = False
            state.consec_failures = 0
            state.metrics_text = metrics_text
            state.trace = trace_payload
            if cpu_payload is not None:
                state.cpu = cpu_payload
            if profile_payload is not None:
                state.profile = profile_payload
            self._counters["collector_scrapes"] += 1
        self._ingest_events(
            events_payload.get("recorder") or t.gateway_id,
            t.gateway_id,
            events_payload.get("events") or [],
        )
        with self._lock:
            nxt = events_payload.get("next_since")
            if isinstance(nxt, int):
                state.events_since = max(state.events_since, nxt)
        return True

    def _tail_local_recorder(self) -> None:
        rec = self.local_recorder
        if rec is None:
            return
        events = rec.events_since(self._local_since)
        if events:
            self._local_since = events[-1]["seq"]
            self._ingest_events(rec.recorder_id, "client", events)

    def _ingest_events(self, recorder_id: str, source: str, events: List[dict]) -> None:
        fresh: List[dict] = []
        with self._lock:
            for ev in events:
                key = (recorder_id, ev.get("seq"))
                if key in self._events_seen:
                    continue
                self._events_seen.add(key)
                tagged = dict(ev)
                tagged.setdefault("gateway", source)
                tagged["recorder"] = recorder_id
                self._events.append(tagged)
                fresh.append(tagged)
                self._counters["collector_events_tailed"] += 1
            # the seen-set must stay bounded like the ring it mirrors
            if len(self._events_seen) > 4 * self._events.maxlen:
                self._events_seen = {(e["recorder"], e["seq"]) for e in self._events}
            fh = self._ensure_log_fh_locked()
        if fh is not None and fresh:
            try:
                for ev in fresh:
                    fh.write(json.dumps(ev, sort_keys=True) + "\n")
                fh.flush()
            except OSError as e:
                logger.fs.warning(f"[collector] fleet log write failed: {e}")

    def _ensure_log_fh_locked(self):
        if self.fleet_log_path is None:
            return None
        if self._log_fh is None:
            try:
                Path(self.fleet_log_path).parent.mkdir(parents=True, exist_ok=True)
                self._log_fh = open(self.fleet_log_path, "a")
            except OSError as e:
                logger.fs.warning(f"[collector] cannot open fleet log {self.fleet_log_path}: {e}")
                self.fleet_log_path = None
                return None
        return self._log_fh

    # ---- merged views ----

    def merged_trace(self) -> dict:
        with self._lock:
            scrapes = [(s.target.meta(), s.trace) for s in self._states.values() if s.trace is not None]
        return merge_traces(scrapes)

    def fleet_metrics_text(self) -> str:
        with self._lock:
            per_gateway = {
                gid: (s.target.meta(), s.metrics_text)
                for gid, s in self._states.items()
                if s.metrics_text is not None
            }
        return render_fleet_metrics(per_gateway)

    def fleet_events(self) -> List[dict]:
        """The merged fleet log, ordered by event time then (recorder, seq) —
        one record of everything that happened across the fleet, post-mortem
        ready. Events that carry a monotonic epoch anchor (``anchor + mono``,
        stamped by every FlightRecorder since the timeline PR) sort by the
        anchored monotonic timestamp instead of raw ``ts``: a wall-clock step
        (NTP slew, suspend/restore) mid-transfer shifts ``ts`` but not the
        anchored stream, so one recorder's events can never reorder against
        their own sequence numbers."""
        with self._lock:
            events = list(self._events)
        events.sort(key=lambda e: (event_epoch(e), e.get("recorder", ""), e.get("seq", 0)))
        return events

    def cpu_profiles(self) -> Dict[str, dict]:
        with self._lock:
            return {gid: s.cpu for gid, s in self._states.items() if s.cpu is not None}

    def profile_summaries(self) -> Dict[str, dict]:
        """Per-gateway sampling-profiler summaries (core-budget input); only
        gateways with the profiler armed AND the new route appear."""
        with self._lock:
            return {gid: s.profile for gid, s in self._states.items() if s.profile is not None}

    def bottleneck(self) -> dict:
        return bottleneck_report(self.merged_trace(), self.cpu_profiles(), self.profile_summaries())

    def stale_gateways(self) -> List[str]:
        with self._lock:
            return sorted(gid for gid, s in self._states.items() if s.stale)

    def counters(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["collector_gateways"] = len(self._states)
            out["collector_stale_gateways"] = sum(1 for s in self._states.values() if s.stale)
            out["collector_fleet_events"] = len(self._events)
        return out


def scrape_trace_once(urls: Sequence[str], token: Optional[str] = None, timeout: float = 30.0) -> dict:
    """One-shot multi-gateway trace fetch + merge (``skyplane-tpu trace
    export --url A --url B`` / ``bottleneck --url``). Gateway identity comes
    from each /status probe when reachable, else the URL itself."""
    from skyplane_tpu_torch.gateway.control_auth import control_session

    scrapes: List[Tuple[dict, dict]] = []
    for url in urls:
        base = api_base_of(url)
        session = control_session(token)
        meta = {"gateway": base, "region": ""}
        try:
            status = session.get(f"{base}/status", timeout=timeout).json()
            meta = {"gateway": status.get("gateway_id") or base, "region": status.get("region") or ""}
        except Exception:  # noqa: BLE001 - identity probe is best-effort
            pass
        resp = session.get(f"{base}/trace", timeout=timeout)
        resp.raise_for_status()
        scrapes.append((meta, resp.json()))
    return merge_traces(scrapes)
