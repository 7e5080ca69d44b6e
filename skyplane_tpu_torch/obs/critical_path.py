"""DAG-aware critical-path solver over job timeline intervals.

ROADMAP item 4's stall is a time-attribution problem: the e2e speedup is
stuck at 1.48-1.60x (vs a ~6x wire ratio) because ~2 s of *fixed* overhead
dominates small corpora, and no existing instrument says which phase owns
it. This module is the analysis half of the answer (obs/timeline.py builds
the intervals, this solves them):

  * :func:`critical_path` — longest weighted path through a DAG of timed
    intervals (PERT-style: node weight = interval duration, edge slack =
    successor start minus predecessor end). Deterministic tie-breaks (lexical
    by node name) so reports and tests are stable; edges that reference
    missing intervals are tolerated and dropped (a partially sampled job
    still yields its best-effort path, it never throws).
  * :func:`fit_fixed_overhead` — closed-form least-squares fit of
    ``wall = overhead_s + bytes / rate`` across >= 3 corpus sizes: the
    fixed-vs-byte-scaled decomposition that turns "the transfer is slow"
    into "1.9 s is size-independent overhead, go read the waterfall".

Everything here is pure computation on plain dicts — no I/O, no clocks —
so the solver unit tests (tests/unit/test_critical_path.py) pin exact
paths and slacks. docs/observability.md "Job timelines & critical path"
documents the report these functions feed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: duration below which an interval is reported but never named the "largest"
#: phase — guards the headline against 0-length markers
MIN_HEADLINE_DUR_S = 1e-9


def _dur(node: dict) -> float:
    """Non-negative duration of one interval node."""
    try:
        return max(0.0, float(node["end"]) - float(node["start"]))
    except (KeyError, TypeError, ValueError):
        return 0.0


def _toposort(names: List[str], preds: Dict[str, List[str]], succs: Dict[str, List[str]]) -> List[str]:
    """Kahn topological order, lexical tie-break. Raises ValueError on a
    cycle — the builders only ever emit DAGs, so a cycle is a caller bug
    worth surfacing loudly rather than silently mis-attributing time."""
    indeg = {n: len(preds.get(n, [])) for n in names}
    ready = sorted(n for n in names if indeg[n] == 0)
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        grew = False
        for s in succs.get(n, []):
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
                grew = True
        if grew:
            ready.sort()
    if len(order) != len(names):
        raise ValueError("critical_path: edge set contains a cycle")
    return order


def critical_path(nodes: Sequence[dict], edges: Iterable[Tuple[str, str]]) -> dict:
    """Longest weighted path through interval ``nodes`` following ``edges``.

    ``nodes`` are dicts with at least ``name``/``start``/``end`` (epoch
    seconds); ``edges`` are ``(pred_name, succ_name)`` pairs. Edges naming
    an interval that was never sampled are dropped (missing-interval
    tolerance): the path is computed over what exists. Returns::

        {
          "path": [name, ...],          # critical path, source -> sink
          "length_s": float,            # sum of durations along the path
          "slack_s": {"u->v": float},   # per-edge gap: start(v) - end(u)
          "on_path": {"u->v": bool},    # which edges the path traverses
          "nodes": {name: {"start", "end", "dur_s"}},
          "dropped_edges": [...],       # edges naming missing intervals
        }
    """
    by_name: Dict[str, dict] = {}
    for n in nodes:
        name = str(n.get("name", ""))
        if not name:
            continue
        # duplicate names: keep the widest envelope (repeat phases merge)
        if name in by_name:
            prev = by_name[name]
            prev["start"] = min(float(prev["start"]), float(n.get("start", prev["start"])))
            prev["end"] = max(float(prev["end"]), float(n.get("end", prev["end"])))
        else:
            by_name[name] = {"name": name, "start": float(n.get("start", 0.0)), "end": float(n.get("end", 0.0))}

    names = sorted(by_name)
    preds: Dict[str, List[str]] = {n: [] for n in names}
    succs: Dict[str, List[str]] = {n: [] for n in names}
    kept: List[Tuple[str, str]] = []
    dropped: List[Tuple[str, str]] = []
    seen_edges = set()
    for u, v in edges:
        u, v = str(u), str(v)
        if (u, v) in seen_edges or u == v:
            continue
        seen_edges.add((u, v))
        if u not in by_name or v not in by_name:
            dropped.append((u, v))
            continue
        kept.append((u, v))
        preds[v].append(u)
        succs[u].append(v)
    for n in names:
        preds[n].sort()
        succs[n].sort()

    order = _toposort(names, preds, succs)

    # PERT forward pass: longest cumulative duration ending at each node.
    best: Dict[str, float] = {}
    best_pred: Dict[str, Optional[str]] = {}
    for n in order:
        node_dur = _dur(by_name[n])
        incoming = preds[n]
        if not incoming:
            best[n] = node_dur
            best_pred[n] = None
            continue
        # deterministic: iterate sorted preds, strict > keeps the lexically
        # first predecessor on ties
        pick, pick_len = None, -1.0
        for p in incoming:
            if best[p] > pick_len:
                pick, pick_len = p, best[p]
        best[n] = pick_len + node_dur
        best_pred[n] = pick

    if not names:
        return {"path": [], "length_s": 0.0, "slack_s": {}, "on_path": {}, "nodes": {}, "dropped_edges": []}

    sink = max(names, key=lambda n: (best[n], n))
    # lexical tie-break must prefer the SMALLEST name among equals, so redo
    # the argmax explicitly
    sink_len = max(best.values())
    sink = sorted(n for n in names if best[n] == sink_len)[0]

    path: List[str] = []
    cur: Optional[str] = sink
    while cur is not None:
        path.append(cur)
        cur = best_pred[cur]
    path.reverse()

    path_edges = set(zip(path, path[1:]))
    slack = {f"{u}->{v}": float(by_name[v]["start"]) - float(by_name[u]["end"]) for u, v in kept}
    on_path = {f"{u}->{v}": (u, v) in path_edges for u, v in kept}
    return {
        "path": path,
        "length_s": float(sink_len),
        "slack_s": slack,
        "on_path": on_path,
        "nodes": {n: {"start": by_name[n]["start"], "end": by_name[n]["end"], "dur_s": _dur(by_name[n])} for n in names},
        "dropped_edges": [f"{u}->{v}" for u, v in dropped],
    }


def largest_node(result: dict, names: Optional[Iterable[str]] = None) -> Optional[str]:
    """The single largest interval on the critical path (optionally limited
    to ``names``) — the headline of the waterfall report."""
    candidates = set(result.get("path", []))
    if names is not None:
        candidates &= set(names)
    best_name, best_dur = None, MIN_HEADLINE_DUR_S
    for n in sorted(candidates):
        dur = result["nodes"].get(n, {}).get("dur_s", 0.0)
        if dur > best_dur:
            best_name, best_dur = n, dur
    return best_name


def fit_fixed_overhead(samples: Sequence[Tuple[float, float]]) -> Optional[dict]:
    """Least-squares fit of ``wall = overhead_s + bytes / rate`` over
    ``(bytes, wall_s)`` samples; needs >= 3 samples spanning > 1 distinct
    size (else the slope is unidentifiable and we return None).

    Returns ``{"overhead_s", "rate_bytes_per_s", "r2", "n"}``. ``rate`` is
    ``inf`` when the slope fits <= 0 (wall did not grow with bytes — all
    overhead); ``overhead_s`` is clamped at 0 (a negative intercept means
    overhead is below measurement noise, not negative time).
    """
    pts = [(float(b), float(w)) for b, w in samples if w > 0.0 and b >= 0.0]
    if len(pts) < 3 or len({b for b, _ in pts}) < 2:
        return None
    n = float(len(pts))
    sx = sum(b for b, _ in pts)
    sy = sum(w for _, w in pts)
    sxx = sum(b * b for b, _ in pts)
    sxy = sum(b * w for b, w in pts)
    denom = n * sxx - sx * sx
    if denom <= 0.0:
        return None
    slope = (n * sxy - sx * sy) / denom  # seconds per byte
    intercept = (sy - slope * sx) / n
    mean_y = sy / n
    ss_tot = sum((w - mean_y) ** 2 for _, w in pts)
    ss_res = sum((w - (intercept + slope * b)) ** 2 for b, w in pts)
    r2 = 1.0 - (ss_res / ss_tot) if ss_tot > 0.0 else 1.0
    return {
        "overhead_s": max(0.0, intercept),
        "rate_bytes_per_s": (1.0 / slope) if slope > 0.0 else float("inf"),
        "r2": r2,
        "n": int(n),
    }
