"""Runtime lock-order witness: the dynamic half of the concurrency gate.

The static pass (``analysis/lockgraph.py``) proves acquisition-order
acyclicity over the edges it can *resolve*; this module proves it over the
edges that actually *happen*. Every hot module wraps its locks in one line —

    self._lock = lockcheck.wrap(threading.Lock(), "ChunkStore._lock")

— and the contract mirrors the tracer's (``obs/tracer.py``):

  * **Disabled means free.** With ``SKYPLANE_TPU_LOCKCHECK`` unset/0,
    ``wrap()`` returns the lock object UNCHANGED — not a proxy, the very
    same object. Zero indirection, zero allocation, test-asserted.
  * **Enabled** (``SKYPLANE_TPU_LOCKCHECK=1``), each lock becomes a
    :class:`WitnessLock` proxy that keeps a per-thread held-stack, folds
    every acquisition into a process-wide observed lock-order graph (nodes
    keyed by the wrap name, i.e. class-level like the static pass), and
    **raises** :class:`LockOrderViolation` carrying BOTH witness stacks the
    moment an acquisition would close a cycle — the deadlock that would have
    needed the right interleaving to fire in production fails loudly on the
    first run whose code path merely *permits* it.
  * Per-lock hold/contention nanoseconds export through the
    :class:`~skyplane_tpu_torch.obs.metrics.MetricsRegistry`
    (``skyplane_lock_hold_ns{lock="..."}`` etc.) and the daemon serves the
    full profile at ``GET /api/v1/profile/locks`` — lock contention joins
    the bottleneck-attribution surface (docs/observability.md).

The acquire/release bodies are deliberately inlined and allocation-light
(one held-stack tuple per acquire, the acquisition site kept as a raw frame
reference; witness strings format lazily on the rare new-edge/violation
paths; stats are
per-instance GIL-bumped ints, the codebase's standard approximate-monitoring
convention) — the chaos soak gates the measured tax at <5%
(``lockcheck_overhead_pct`` in scripts/check_bench_json.py).

Semantics notes:

  * Reentrant acquisition of the SAME lock object (RLock) is recognized by
    identity and never recorded as an order edge.
  * Two instances of the same class share a graph node (same wrap name), and
    same-name edges are skipped — instance-level ABBA between two peers of
    one class is out of scope here, exactly as in the static pass.
  * ``threading.Condition`` integrates by wrapping the lock the condition is
    built over (``Condition(lockcheck.wrap(...))``): the proxy forwards the
    condition protocol (``_release_save``/``_acquire_restore``/``_is_owned``
    — required, or Condition's trial-acquire fallback mis-reports ownership
    of an RLock), and a ``wait()``-driven re-acquire is pushed as reentrant:
    it keeps the held-stack truthful without recording an order edge, since
    a post-wait re-acquire is not an ordering choice the code made.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

ENV = "SKYPLANE_TPU_LOCKCHECK"

#: a site is the raw caller frame, captured by reference (one _getframe, no
#: extraction) and formatted ONLY on the rare new-edge/violation paths
Site = Optional[object]

_now = time.perf_counter_ns


class LockOrderViolation(RuntimeError):
    """An acquisition would close a cycle in the observed lock-order graph."""


def enabled() -> bool:
    return os.environ.get(ENV, "0") not in ("", "0", "false", "False")


# ---------------------------------------------------------------- global state

_graph_lock = threading.Lock()
#: name -> name -> witness string for the FIRST observation of that edge
_edges: Dict[str, Dict[str, str]] = {}
#: every live WitnessLock (stats live per instance, aggregated by name at
#: profile time — no global lock on the acquire/release path)
_instances: "weakref.WeakSet[WitnessLock]" = weakref.WeakSet()
#: name -> [acq, contention_ns, hold_ns, max_hold_ns] folded in when an
#: instance is garbage-collected — per-name totals (and the Prometheus
#: counters derived from them) must never go BACKWARD because a short-lived
#: lock (a per-connection _ConnState) died between two scrapes.
#: __del__ publishes through `_retired_queue` (deque.append is GIL-atomic,
#: NO lock taken) because a finalizer may run via an allocation-triggered GC
#: pass ON A THREAD THAT ALREADY HOLDS `_graph_lock` — taking it in __del__
#: would deadlock the deadlock-prevention tool. The queue drains into
#: `_retired` under the lock at aggregation time.
_retired: Dict[str, List[int]] = {}
_retired_queue: "deque" = deque()
_violations = 0
_metrics_registered = False
_tls = threading.local()


def reset() -> None:
    """Drop every observed edge/stat (tests and soak baselines)."""
    global _violations
    with _graph_lock:
        _edges.clear()
        _retired.clear()
        _retired_queue.clear()
        _violations = 0
        for inst in list(_instances):
            inst._acq = inst._contention_ns = inst._hold_ns = inst._max_hold_ns = 0


_SRC_FILE = __file__


def _fmt_site(site: Site) -> str:
    """Format a captured frame, walking out of proxy/Condition internals
    (this module's frames and threading.py's — matched by exact file, so a
    caller whose filename merely CONTAINS 'lockwitness' is not skipped).
    Line numbers read at format time — exact for a violation raised at the
    acquire, approximate (still inside the holding function) for a holder
    whose frame has advanced."""
    f = site
    for _ in range(4):
        if f is None:
            break
        co = f.f_code
        fn = co.co_filename
        if fn != _SRC_FILE and not fn.endswith("threading.py"):
            return f"{fn}:{f.f_lineno} in {co.co_name}"
        f = f.f_back
    return "<unknown>"


def _reachable(src: str, dst: str) -> bool:
    """Path src -> dst over the observed edges (caller holds _graph_lock)."""
    seen = {src}
    queue = [src]
    while queue:
        cur = queue.pop()
        if cur == dst:
            return True
        for nxt in _edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                queue.append(nxt)
    return False


def _witness_path(src: str, dst: str) -> List[str]:
    """The stored witness strings along one src -> dst path (holds _graph_lock)."""
    prev: Dict[str, str] = {}
    queue = [src]
    seen = {src}
    while queue:
        cur = queue.pop(0)
        if cur == dst:
            break
        for nxt in _edges.get(cur, {}):
            if nxt not in seen:
                seen.add(nxt)
                prev[nxt] = cur
                queue.append(nxt)
    if dst not in seen:
        return []
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    path.reverse()
    return [f"{a} -> {b}: {_edges[a][b]}" for a, b in zip(path, path[1:])]


#: a held-stack entry is a plain tuple (no class: tuple display is a single
#: C-level op on the per-acquire path): (lock, name, t_acq_ns, site_frame,
#: reentrant)
_H_LOCK, _H_NAME, _H_T, _H_SITE, _H_REENTRANT = range(5)


class WitnessLock:
    """Proxy around a Lock/RLock with held-stack + order-graph accounting."""

    __slots__ = (
        "_inner",
        "name",
        "_iacquire",
        "_irelease",
        "_acq",
        "_contention_ns",
        "_hold_ns",
        "_max_hold_ns",
        "__weakref__",
    )

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name
        # bound methods cached once: one attribute lookup per call instead of
        # a descriptor bind through the inner object every acquire
        self._iacquire = inner.acquire
        self._irelease = inner.release
        self._acq = 0
        self._contention_ns = 0
        self._hold_ns = 0
        self._max_hold_ns = 0
        _instances.add(self)

    # -- the lock protocol (hot path: inlined, no helper calls) --

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = _now()
        ok = self._iacquire(blocking, timeout)
        if not ok:
            return ok
        t1 = _now()
        self._acq += 1
        self._contention_ns += t1 - t0
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
        reentrant = False
        if stack:
            for e in stack:
                if e[0] is self:
                    reentrant = True
                    break
            if not reentrant:
                # a reentrant-marked entry (inner RLock hold, post-wait
                # re-acquire) is still a HELD lock and a valid edge SOURCE;
                # only the acquisition that created it records no edge —
                # orderings chosen in a post-wait body must not escape the
                # graph, or the ABBA they half-form passes silently
                name = self.name
                for e in reversed(stack):
                    if e[1] != name:
                        known = _edges.get(e[1])
                        if known is None or name not in known:
                            # slow path: first observation of this edge
                            self._record_edge(e, sys._getframe(1))
                        break
        stack.append((self, self.name, t1, sys._getframe(1), reentrant))
        return ok

    def release(self) -> None:
        stack = getattr(_tls, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is self:
                    t_acq = stack[i][2]
                    del stack[i]
                    hold_ns = _now() - t_acq
                    self._hold_ns += hold_ns
                    if hold_ns > self._max_hold_ns:
                        self._max_hold_ns = hold_ns
                    break
            # a pop miss = release of a lock this thread never tracked
            # (handed across threads); nothing to account
        self._irelease()

    # `with lock:` discards __enter__'s return value (no adopted call site
    # uses `with lock as x:`), so acquire doubles as __enter__ — one Python
    # call saved per context-managed acquisition
    __enter__ = acquire

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    def __del__(self):
        # publish counters for the persistent per-name totals. LOCK-FREE by
        # design: this may run via an allocation-triggered GC pass on a
        # thread that already holds _graph_lock (see _retired_queue note)
        try:
            _retired_queue.append(
                (self.name, self._acq, self._contention_ns, self._hold_ns, self._max_hold_ns)
            )
        except Exception:  # noqa: BLE001 — interpreter teardown: globals may be gone
            pass

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<WitnessLock {self.name} around {self._inner!r}>"

    # -- order-graph slow path (first observation of an edge) --

    def _record_edge(self, holder: tuple, site: Site) -> None:
        global _violations
        holder_name = holder[_H_NAME]
        # stale-entry guard: threading.Lock may legally be released by a
        # DIFFERENT thread than its acquirer, which leaves the acquirer's
        # held-stack entry behind (release() pops only the releasing
        # thread's stack). A provably-unlocked holder is such a leftover —
        # purge it instead of minting a false edge (and potentially a false
        # LockOrderViolation). Only provable for inners exposing locked();
        # RLocks can't be cross-thread released, so they never go stale.
        inner_locked = getattr(holder[_H_LOCK]._inner, "locked", None)
        if inner_locked is not None and not inner_locked():
            stack = getattr(_tls, "stack", None)
            if stack is not None:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is holder:
                        del stack[i]
                        break
            return
        with _graph_lock:
            targets = _edges.get(holder_name)
            if targets is not None and self.name in targets:
                return  # raced another thread to the same edge
            if _reachable(self.name, holder_name):
                _violations += 1
                reverse = _witness_path(self.name, holder_name)
                msg = (
                    f"lock-order violation: thread {threading.current_thread().name!r} acquiring "
                    f"{self.name} while holding {holder_name}\n"
                    f"  this acquisition: {_fmt_site(site)}\n"
                    f"  {holder_name} was acquired: {_fmt_site(holder[_H_SITE])}\n"
                    "  but the reverse order was already observed:\n    "
                    + "\n    ".join(reverse)
                )
                self._irelease()  # do not leave the inner lock wedged
                raise LockOrderViolation(msg)
            _edges.setdefault(holder_name, {})[self.name] = (
                f"{holder_name} at [{_fmt_site(holder[_H_SITE])}] then {self.name} at "
                f"[{_fmt_site(site)}] (thread {threading.current_thread().name!r})"
            )

    # -- the Condition protocol --
    #
    # threading.Condition lifts _release_save/_acquire_restore/_is_owned off
    # its lock when present. They MUST be forwarded: Condition's fallback
    # _is_owned probes with a trial acquire(False), which succeeds reentrantly
    # on an owned RLock and mis-reports "not owned" ("cannot wait on
    # un-acquired lock"). The wait() pair keeps the held-stack truthful; the
    # re-acquire is pushed reentrant so it records no order edge.

    def _release_save(self):
        stack = getattr(_tls, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is self:
                    t_acq = stack[i][2]
                    del stack[i]
                    hold_ns = _now() - t_acq
                    self._hold_ns += hold_ns
                    if hold_ns > self._max_hold_ns:
                        self._max_hold_ns = hold_ns
                    break
        inner_rs = getattr(self._inner, "_release_save", None)
        if inner_rs is not None:
            return inner_rs()
        self._irelease()
        return None

    def _acquire_restore(self, state) -> None:
        t0 = _now()
        inner_ar = getattr(self._inner, "_acquire_restore", None)
        if inner_ar is not None:
            inner_ar(state)
        else:
            self._iacquire()
        t1 = _now()
        self._acq += 1
        self._contention_ns += t1 - t0
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
        stack.append((self, self.name, t1, None, True))

    def _is_owned(self) -> bool:
        inner_io = getattr(self._inner, "_is_owned", None)
        if inner_io is not None:
            return bool(inner_io())
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def wrap(lock, name: str):
    """The one-line adoption shim: a no-op passthrough when disabled, a
    :class:`WitnessLock` when ``SKYPLANE_TPU_LOCKCHECK=1``."""
    if not enabled():
        return lock
    _ensure_metrics_registered()
    return WitnessLock(lock, name)


# ---------------------------------------------------------------- exposition


def _aggregate_stats() -> Dict[str, List[int]]:
    """Per-NAME stat totals: every live WitnessLock instance (many instances
    of one class share a name, exactly like the graph nodes) plus the
    retired totals of instances already garbage-collected — so the exported
    counters are monotonic across scrapes.

    Ordering matters for monotonicity: the live snapshot is taken FIRST and
    holds strong refs (nothing in it can retire mid-sum), and any instance
    that died before the snapshot has already published to _retired_queue
    (PEP 442: finalizers run before weakrefs clear), which is drained next —
    no instance can fall between the two views."""
    live = list(_instances)
    with _graph_lock:
        while True:
            try:
                name, acq, cont, hold, max_hold = _retired_queue.popleft()
            except IndexError:
                break
            st = _retired.setdefault(name, [0, 0, 0, 0])
            st[0] += acq
            st[1] += cont
            st[2] += hold
            if max_hold > st[3]:
                st[3] = max_hold
        totals: Dict[str, List[int]] = {name: list(st) for name, st in _retired.items()}
    for inst in live:
        st = totals.setdefault(inst.name, [0, 0, 0, 0])
        st[0] += inst._acq
        st[1] += inst._contention_ns
        st[2] += inst._hold_ns
        if inst._max_hold_ns > st[3]:
            st[3] = inst._max_hold_ns
    return totals


def _metrics_provider() -> Dict[str, Dict[str, int]]:
    items = _aggregate_stats().items()
    return {
        "acquisitions": {name: st[0] for name, st in items},
        "contention_ns": {name: st[1] for name, st in items},
        "hold_ns": {name: st[2] for name, st in items},
    }


def _ensure_metrics_registered() -> None:
    global _metrics_registered
    if _metrics_registered:
        return
    with _graph_lock:
        if _metrics_registered:
            return
        _metrics_registered = True
    from skyplane_tpu_torch.obs.metrics import get_registry

    get_registry().register_labeled_provider("lock", _metrics_provider, label="lock")


def _acyclic_locked() -> bool:
    """Cycle test over the observed graph (caller holds _graph_lock). The
    witness raises before a cycle can be RECORDED, so this is True unless a
    violation was swallowed by a caller; exported for the soak gate."""
    color: Dict[str, int] = {}

    def dfs(node: str) -> bool:
        color[node] = 1
        for nxt in _edges.get(node, ()):
            c = color.get(nxt, 0)
            if c == 1 or (c == 0 and not dfs(nxt)):
                return False
        color[node] = 2
        return True

    return all(color.get(n, 0) == 2 or dfs(n) for n in list(_edges))


def lock_profile() -> dict:
    """The ``GET /api/v1/profile/locks`` payload: per-lock hold/contention
    totals, the observed order graph with per-edge witnesses, acyclicity."""
    locks = {
        name: {
            "acquisitions": st[0],
            "contention_ns": st[1],
            "hold_ns": st[2],
            "max_hold_ns": st[3],
        }
        for name, st in sorted(_aggregate_stats().items())
    }
    with _graph_lock:
        edges = [
            {"from": a, "to": b, "witness": w}
            for a in sorted(_edges)
            for b, w in sorted(_edges[a].items())
        ]
        acyclic = _acyclic_locked()
        violations = _violations
    return {
        "enabled": enabled(),
        "violations": violations,
        "locks": locks,
        "order_edges": edges,
        "acyclic": acyclic,
    }
