"""Job-level timeline: PhaseClock instrumentation + per-job timeline builder.

The e2e campaign (ROADMAP item 4) is blocked on attribution, not bandwidth:
~2 s of fixed overhead dominates small corpora, and the chunk-level spans
(PR 5), fleet event log (PR 9) and CPU profiler (PR 12) all start *after*
the client-side phases — plan, provision, credential staging, the first
batch's kernel build, connection-pool warmup — that own most of that time. This
module closes the gap:

  * :class:`PhaseClock` journals lifecycle phases into the flight recorder
    as paired ``phase.<name>`` events (``edge="start"`` / ``edge="end"``
    sharing a ``phase_id``), stamped with the per-recorder monotonic epoch
    anchor so cross-process timelines don't skew when wall clocks drift.
    Instrumented sites: api/pipeline.py (plan, teardown), api/dataplane.py
    (provision, cred_stage, gateway_boot), api/tracker.py (dispatch, drain),
    ops/batch_runner.py (first_compile), the gateway sender (pool_warm) and
    service/controller.py (warm dispatch — so service-vs-batch overhead is
    directly comparable).
  * :func:`build_timeline` ingests the PR-9 fleet JSONL log plus optional
    per-gateway Chrome-trace span exports (stitched via recorder/gateway
    tags) and assembles one per-job timeline: phase intervals, per-hop
    stage envelopes, transfer markers.
  * :func:`timeline_dag` turns that timeline into interval nodes + temporal
    precedence edges for the critical-path solver
    (:mod:`skyplane_tpu_torch.obs.critical_path`); :func:`render_waterfall`
    prints the report, :func:`perfetto_export` emits a trace that loads in
    Perfetto.

Surfaced as ``skyplane-tpu timeline <transfer-id>`` and
``GET /api/v1/timeline`` on the service controller; documented in
docs/observability.md "Job timelines & critical path".
"""

from __future__ import annotations

import json
import os
import tempfile
import uuid
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from skyplane_tpu_torch.obs.critical_path import critical_path, fit_fixed_overhead, largest_node  # noqa: F401 - largest_node re-exported
from skyplane_tpu_torch.obs.events import (
    ALL_PHASES,
    PH_DRAIN,
    FlightRecorder,
    event_epoch,
    get_recorder,
)

#: where the tracker's collector banks fleet JSONL logs (api/tracker.py) —
#: ``skyplane-tpu timeline`` resolves transfer ids against this directory
FLEET_DIR_ENV = "SKYPLANE_TPU_FLEET_DIR"
DEFAULT_FLEET_DIR = str(Path(tempfile.gettempdir()) / "skyplane_tpu_fleet")

#: phases whose cost does NOT scale with bytes — the "fixed overhead" ledger
#: the waterfall decomposes against. ``drain`` (bytes actually moving) and
#: the per-hop stage envelopes are the byte-scaled remainder.
FIXED_PHASE_NAMES = frozenset(
    p[len("phase."):] for p in ALL_PHASES if p not in (PH_DRAIN,)
)

#: floating-point guard for "v starts at-or-after u ends" precedence; phase
#: stamps come from one monotonic clock so true ties are exact
PRECEDENCE_EPS_S = 1e-9


# ------------------------------------------------------------- instrumentation


class PhaseClock:
    """Journals lifecycle phases for one job into a flight recorder.

    Each :meth:`phase` context records a ``start``/``end`` event pair sharing
    a fresh ``phase_id`` (so interleaved recorders pair unambiguously); the
    ``end`` event is recorded even when the body raises, so a failed phase
    still shows its true extent in the waterfall. Cold paths only — one
    recorder lock per edge.
    """

    def __init__(self, job: str = "", scope: str = "client", recorder: Optional[FlightRecorder] = None):
        self.job = job
        self.scope = scope
        self._recorder = recorder or get_recorder()

    @contextmanager
    def phase(self, kind: str, **fields):
        phase_id = uuid.uuid4().hex[:12]
        self._recorder.record(kind, edge="start", phase_id=phase_id, job=self.job, scope=self.scope, **fields)
        try:
            yield
        finally:
            self._recorder.record(kind, edge="end", phase_id=phase_id, job=self.job, scope=self.scope, **fields)

    def mark(self, kind: str, **fields) -> None:
        """One instantaneous marker event (no pairing)."""
        self._recorder.record(kind, job=self.job, scope=self.scope, **fields)


@contextmanager
def phase_span(kind: str, job: str = "", scope: str = "gateway", recorder: Optional[FlightRecorder] = None, **fields):
    """One-shot phase context for deep call sites (the first kernel build
    under the batch runner, first sender dial) that have no PhaseClock in scope."""
    with PhaseClock(job=job, scope=scope, recorder=recorder).phase(kind, **fields):
        yield


def phase_begin(kind: str, job: str = "", scope: str = "gateway",
                recorder: Optional[FlightRecorder] = None, **fields):
    """Imperative begin for call sites where a ``with`` block would force
    re-indenting a large existing body: records the start edge now and
    returns an idempotent zero-arg ``end()`` closure (call it from the
    site's ``finally``). Prefer :meth:`PhaseClock.phase` everywhere else."""
    rec = recorder or get_recorder()
    phase_id = uuid.uuid4().hex[:12]
    rec.record(kind, edge="start", phase_id=phase_id, job=job, scope=scope, **fields)
    fired = []

    def end() -> None:
        if not fired:
            fired.append(True)
            rec.record(kind, edge="end", phase_id=phase_id, job=job, scope=scope, **fields)

    return end


# --------------------------------------------------------------- fleet log IO


def fleet_dir() -> Path:
    return Path(os.environ.get(FLEET_DIR_ENV, "").strip() or DEFAULT_FLEET_DIR)


def load_fleet_log(path) -> List[dict]:
    """Parse one fleet JSONL log; malformed lines are skipped (a crash while
    appending must not make the whole post-mortem unreadable)."""
    events: List[dict] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return events
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if isinstance(ev, dict):
            events.append(ev)
    return events


def resolve_fleet_log(selector: str = "latest", directory=None) -> Optional[Path]:
    """Map a transfer id (or ``latest``) to a fleet JSONL log: filename
    substring match first, then a scan of each log's ``job`` tags; ``latest``
    is the newest log by mtime."""
    d = Path(directory) if directory is not None else fleet_dir()
    try:
        logs = sorted(d.glob("*.events.jsonl"), key=lambda p: p.stat().st_mtime, reverse=True)
    except OSError:
        return None
    if not logs:
        return None
    if not selector or selector == "latest":
        return logs[0]
    for p in logs:
        if selector in p.name:
            return p
    for p in logs:
        for ev in load_fleet_log(p):
            for key in ("job", "transfer_id"):
                tag = ev.get(key)
                # prefix match: transfer ids are 16-32 hex chars and users
                # paste the head of one (git-style), not the whole thing
                if isinstance(tag, str) and tag and tag.startswith(selector):
                    return p
    return None


# ------------------------------------------------------------ timeline builder


def _interval_name(kind: str, scope: str) -> str:
    short = kind[len("phase."):] if kind.startswith("phase.") else kind
    if scope and scope not in ("client", ""):
        return f"{scope}.{short}"
    return short


def build_timeline(events: Sequence[dict], traces=None, job: Optional[str] = None) -> dict:
    """Assemble one per-job timeline from flight-recorder ``events`` (the
    fleet JSONL log or a live recorder dump) plus optional Chrome-trace
    exports.

    Pairing is by ``(recorder, kind, phase_id)``; a start with no end (crash
    mid-phase) becomes an interval stretching to the last timestamp seen and
    is listed under ``incomplete``. Timestamps prefer the per-recorder
    monotonic anchor (:func:`skyplane_tpu_torch.obs.events.event_epoch`).
    ``traces`` may be one merged Chrome-trace dict or ``(meta, trace)``
    pairs; spans named in the collector's STAGE_SPANS table become per-hop
    ``hop:<gateway>:<stage>`` envelope intervals.
    """
    opens: Dict[tuple, Tuple[float, dict]] = {}
    raw_intervals: List[dict] = []
    markers: List[dict] = []
    incomplete: List[str] = []
    t_seen: List[float] = []

    for ev in events:
        kind = str(ev.get("kind", ""))
        t = event_epoch(ev)
        if t > 0.0:
            t_seen.append(t)
        if not kind.startswith("phase."):
            if kind.startswith("transfer."):
                markers.append(dict(ev))
            continue
        if job and ev.get("job") and ev.get("job") != job:
            continue
        key = (ev.get("recorder", ""), kind, ev.get("phase_id", ""))
        edge = ev.get("edge")
        if edge == "start":
            opens[key] = (t, ev)
        elif edge == "end":
            start_t, start_ev = opens.pop(key, (t, ev))
            raw_intervals.append(_mk_interval(start_ev, start_t, t, complete=True))

    t1 = max(t_seen) if t_seen else 0.0
    for (_, _, _), (start_t, start_ev) in sorted(opens.items(), key=lambda kv: kv[1][0]):
        iv = _mk_interval(start_ev, start_t, max(t1, start_t), complete=False)
        raw_intervals.append(iv)
        incomplete.append(iv["name"])

    # merge same-name intervals (e.g. first_compile fired on several
    # gateways) into one envelope, accumulating busy time for the report
    phases: Dict[str, dict] = {}
    for iv in raw_intervals:
        cur = phases.get(iv["name"])
        if cur is None:
            phases[iv["name"]] = iv
            continue
        cur["busy_s"] += iv["busy_s"]
        cur["count"] += 1
        cur["start"] = min(cur["start"], iv["start"])
        cur["end"] = max(cur["end"], iv["end"])
        cur["dur_s"] = max(0.0, cur["end"] - cur["start"])
        cur["complete"] = cur["complete"] and iv["complete"]

    hops = _hop_envelopes(traces) if traces else []

    all_starts = [iv["start"] for iv in phases.values()] + [h["start"] for h in hops]
    all_ends = [iv["end"] for iv in phases.values()] + [h["end"] for h in hops]
    t0 = min(all_starts) if all_starts else 0.0
    t_end = max(all_ends) if all_ends else t0

    bytes_total, transfer_seconds, inferred_job = None, None, job or ""
    for m in markers:
        if m.get("kind") == "transfer.complete":
            if isinstance(m.get("bytes"), (int, float)):
                bytes_total = int(m["bytes"])
            if isinstance(m.get("seconds"), (int, float)):
                transfer_seconds = float(m["seconds"])
        if not inferred_job and m.get("job"):
            inferred_job = str(m["job"])
    if not inferred_job:
        for iv in raw_intervals:
            if iv.get("job"):
                inferred_job = str(iv["job"])
                break

    return {
        "job": inferred_job,
        "t0": t0,
        "t1": t_end,
        "wall_s": max(0.0, t_end - t0),
        "phases": sorted(phases.values(), key=lambda i: (i["start"], i["name"])),
        "hops": hops,
        "markers": markers,
        "incomplete": sorted(set(incomplete)),
        "bytes": bytes_total,
        "transfer_seconds": transfer_seconds,
    }


def _mk_interval(start_ev: dict, start_t: float, end_t: float, complete: bool) -> dict:
    end_t = max(end_t, start_t)
    return {
        "name": _interval_name(str(start_ev.get("kind", "")), str(start_ev.get("scope", ""))),
        "kind": start_ev.get("kind", ""),
        "scope": start_ev.get("scope", ""),
        "job": start_ev.get("job", ""),
        "recorder": start_ev.get("recorder", ""),
        "gateway": start_ev.get("gateway", ""),
        "start": start_t,
        "end": end_t,
        "dur_s": end_t - start_t,
        "busy_s": end_t - start_t,
        "count": 1,
        "complete": complete,
    }


def _hop_envelopes(traces) -> List[dict]:
    """Per-(gateway, stage) envelope intervals from Chrome-trace exports —
    the per-hop rows of the waterfall. Spans stitch to hops via the scrape
    metadata's gateway tag (or pid for a raw single-gateway export)."""
    from skyplane_tpu_torch.obs.collector import STAGE_SPANS  # lazy: keep import light for instrumented call sites

    span_to_stage = {v: k for k, v in STAGE_SPANS.items()}
    if isinstance(traces, dict):
        traces = [({}, traces)]
    agg: Dict[Tuple[str, str], dict] = {}
    for meta, tr in traces:
        gw = str((meta or {}).get("gateway", "") or "local")
        for ev in (tr or {}).get("traceEvents", []):
            stage = span_to_stage.get(ev.get("name"))
            if stage is None:
                continue
            ph = ev.get("ph")
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if ph == "X":
                dur = ev.get("dur")
            elif ph == "b":
                dur = (ev.get("args") or {}).get("dur_us")
            else:
                continue
            if not isinstance(dur, (int, float)):
                continue
            start = float(ts) / 1e6
            end = start + float(dur) / 1e6
            cur = agg.setdefault(
                (gw, stage),
                {"name": f"hop:{gw}:{stage}", "gateway": gw, "stage": stage,
                 "start": start, "end": end, "busy_s": 0.0, "count": 0},
            )
            cur["start"] = min(cur["start"], start)
            cur["end"] = max(cur["end"], end)
            cur["busy_s"] += float(dur) / 1e6
            cur["count"] += 1
    out = []
    for cur in agg.values():
        cur["dur_s"] = max(0.0, cur["end"] - cur["start"])
        out.append(cur)
    out.sort(key=lambda h: (h["start"], h["name"]))
    return out


# ----------------------------------------------------------- DAG + attribution


def classify(name: str) -> str:
    """``fixed`` (size-independent overhead) vs ``scaled`` (grows with
    bytes). Scope-prefixed names classify by their base phase."""
    base = name.rsplit(".", 1)[-1]
    if name.startswith("hop:"):
        return "scaled"
    return "fixed" if base in FIXED_PHASE_NAMES else "scaled"


def timeline_dag(timeline: dict) -> Tuple[List[dict], List[Tuple[str, str]]]:
    """Interval nodes + temporal precedence edges for the solver.

    Edge ``u -> v`` iff ``v`` starts at-or-after ``u`` ends AND no third
    interval fits wholly between them (transitive reduction, so the slack
    report stays readable). Overlapping intervals get no edge — they are
    parallel branches, which is exactly what keeps a nested or concurrent
    phase (gateway-side first_compile under the client's drain) from double
    counting wall-clock on the critical path.
    """
    nodes = [
        {"name": iv["name"], "start": iv["start"], "end": iv["end"]}
        for iv in list(timeline.get("phases", [])) + list(timeline.get("hops", []))
    ]
    edges: List[Tuple[str, str]] = []
    for u in nodes:
        for v in nodes:
            if u is v or v["start"] < u["end"] - PRECEDENCE_EPS_S:
                continue
            between = any(
                w is not u and w is not v
                and w["start"] >= u["end"] - PRECEDENCE_EPS_S
                and v["start"] >= w["end"] - PRECEDENCE_EPS_S
                for w in nodes
            )
            if not between:
                edges.append((u["name"], v["name"]))
    return nodes, edges


def solve_timeline(timeline: dict) -> dict:
    """Critical path over the timeline DAG + the attribution summary the
    waterfall and the bench gate both read."""
    nodes, edges = timeline_dag(timeline)
    cp = critical_path(nodes, edges)
    path_set = set(cp["path"])
    fixed_s = sum(cp["nodes"][n]["dur_s"] for n in path_set if classify(n) == "fixed")
    scaled_s = sum(cp["nodes"][n]["dur_s"] for n in path_set if classify(n) == "scaled")
    fixed_names = [iv["name"] for iv in timeline.get("phases", []) if classify(iv["name"]) == "fixed"]
    largest_fixed = None
    best = 0.0
    for iv in timeline.get("phases", []):
        if iv["name"] in fixed_names and iv["dur_s"] > best:
            largest_fixed, best = iv["name"], iv["dur_s"]
    cp["critical_path_s"] = cp["length_s"]
    cp["fixed_s"] = fixed_s
    cp["scaled_s"] = scaled_s
    cp["largest_fixed_phase"] = largest_fixed
    cp["largest_fixed_s"] = best
    cp["wall_s"] = timeline.get("wall_s", 0.0)
    cp["coverage"] = (cp["length_s"] / cp["wall_s"]) if cp.get("wall_s") else 0.0
    return cp


# ------------------------------------------------------------------ rendering


def render_waterfall(
    timeline: dict,
    cp: Optional[dict] = None,
    fit: Optional[dict] = None,
    cost_per_gb: Optional[float] = None,
    width: int = 36,
) -> str:
    """Text waterfall: one row per interval, offset + duration + bar, ``*``
    marks the critical path; footer carries the fixed-vs-scaled split, the
    multi-size fit (when provided) and the $/TB line."""
    cp = cp or solve_timeline(timeline)
    t0 = timeline.get("t0", 0.0)
    wall = max(timeline.get("wall_s", 0.0), 1e-9)
    rows = list(timeline.get("phases", [])) + list(timeline.get("hops", []))
    rows.sort(key=lambda r: (r["start"], r["name"]))
    path_set = set(cp.get("path", []))

    lines = []
    job = timeline.get("job") or "?"
    lines.append(
        f"timeline {job}: wall {timeline.get('wall_s', 0.0):.3f}s, "
        f"critical path {cp.get('length_s', 0.0):.3f}s ({100.0 * cp.get('coverage', 0.0):.1f}% of wall)"
    )
    name_w = max([len(r["name"]) for r in rows], default=8)
    name_w = max(name_w, len("phase"))
    lines.append(f"  {'phase'.ljust(name_w)}  {'start':>9}  {'dur':>8}  path  class   waterfall")
    for r in rows:
        off = r["start"] - t0
        pad = int(round(width * off / wall))
        bar = int(round(width * r["dur_s"] / wall))
        bar = max(bar, 1) if r["dur_s"] > 0 else 0
        mark = "*" if r["name"] in path_set else " "
        cls = classify(r["name"])
        flag = "" if r.get("complete", True) else "  (incomplete)"
        lines.append(
            f"  {r['name'].ljust(name_w)}  {off:>8.3f}s  {r['dur_s']:>7.3f}s   {mark}    {cls:<6}  "
            f"{' ' * pad}{'#' * bar}{flag}"
        )
    lines.append(f"  critical path: {' -> '.join(cp.get('path', [])) or '(none)'}")
    if cp.get("largest_fixed_phase"):
        lines.append(f"  largest fixed cost: {cp['largest_fixed_phase']} ({cp['largest_fixed_s']:.3f}s)")
    lines.append(f"  fixed {cp.get('fixed_s', 0.0):.3f}s | byte-scaled {cp.get('scaled_s', 0.0):.3f}s (on-path)")
    if fit:
        rate = fit.get("rate_bytes_per_s", float("inf"))
        rate_str = f"{rate / 1e6:.1f} MB/s" if rate != float("inf") else "inf"
        lines.append(
            f"  fit ({fit.get('n', 0)} sizes): wall = {fit.get('overhead_s', 0.0):.3f}s + bytes / {rate_str}"
            f"  (r2={fit.get('r2', 0.0):.3f})"
        )
    if cost_per_gb is not None:
        b = timeline.get("bytes") or 0
        dollars = (b / 1e9) * cost_per_gb
        lines.append(f"  egress cost: ${dollars:.4f} total (${cost_per_gb * 1000.0:.2f}/TB at ${cost_per_gb:.4f}/GB)")
    return "\n".join(lines)


def perfetto_export(timeline: dict, cp: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON (loads directly in Perfetto): phases on one
    track per scope, hop envelopes on per-gateway tracks; critical-path
    membership rides ``args`` so it's queryable in the UI."""
    cp = cp or solve_timeline(timeline)
    path_set = set(cp.get("path", []))
    events: List[dict] = []
    events.append({"name": "process_name", "ph": "M", "pid": 1, "args": {"name": f"job {timeline.get('job') or '?'}"}})
    for iv in timeline.get("phases", []):
        events.append(
            {
                "name": iv["name"],
                "cat": "phase",
                "ph": "X",
                "pid": 1,
                "tid": 1 if iv.get("scope") in ("client", "") else 2,
                "ts": iv["start"] * 1e6,
                "dur": max(iv["dur_s"], 0.0) * 1e6,
                "args": {"on_critical_path": iv["name"] in path_set, "class": classify(iv["name"]),
                         "complete": bool(iv.get("complete", True))},
            }
        )
    tid = 10
    gw_tid: Dict[str, int] = {}
    for h in timeline.get("hops", []):
        t = gw_tid.setdefault(h["gateway"], tid + len(gw_tid))
        events.append(
            {
                "name": h["name"],
                "cat": "hop",
                "ph": "X",
                "pid": 1,
                "tid": t,
                "ts": h["start"] * 1e6,
                "dur": max(h["dur_s"], 0.0) * 1e6,
                "args": {"busy_s": h["busy_s"], "count": h["count"], "on_critical_path": h["name"] in path_set},
            }
        )
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": {"job": timeline.get("job") or ""}}


def timeline_report(events: Sequence[dict], traces=None, job: Optional[str] = None,
                    fit_samples: Optional[Sequence[Tuple[float, float]]] = None,
                    cost_per_gb: Optional[float] = None) -> dict:
    """One-call convenience: build + solve + render; the JSON payload behind
    ``skyplane-tpu timeline --json`` and ``GET /api/v1/timeline``."""
    tl = build_timeline(events, traces=traces, job=job)
    cp = solve_timeline(tl)
    fit = fit_fixed_overhead(fit_samples) if fit_samples else None
    return {
        "timeline": tl,
        "critical_path": cp,
        "fit": fit,
        "text": render_waterfall(tl, cp, fit=fit, cost_per_gb=cost_per_gb),
    }


__all__ = [
    "PhaseClock",
    "build_timeline",
    "classify",
    "fit_fixed_overhead",
    "fleet_dir",
    "largest_node",
    "load_fleet_log",
    "perfetto_export",
    "phase_begin",
    "phase_span",
    "render_waterfall",
    "resolve_fleet_log",
    "solve_timeline",
    "timeline_dag",
    "timeline_report",
]
