"""Unified metrics registry with Prometheus text exposition.

Before this module each subsystem exported its own ad-hoc counter dict
(``DataPathStats.EXTERNAL_ZERO``, ``DECODE_COUNTER_ZERO``,
``SENDER_WIRE_COUNTER_ZERO``) behind its own endpoint. The registry absorbs
those dict-returning providers unchanged — their stable schemas stay the
source of truth — and adds native counters, gauges, and histograms for
metrics that have no home in the legacy schemas (e.g. per-chunk decode
latency distribution).

Exposition is the Prometheus text format (version 0.0.4): one ``# HELP`` and
``# TYPE`` line per family, then samples. Absorbed provider values are
exported as gauges (several legacy "counters" are really gauges — queue
depths, in-flight bytes — and a gauge is always scrape-safe); native metrics
carry their true type, including full ``_bucket``/``_sum``/``_count``
histogram series.

The module-level :func:`get_registry` singleton is where long-lived
components (receiver decode pool, sender operators) register their
histograms; the gateway daemon layers its per-daemon providers on top via
``MetricsRegistry(parent=get_registry())`` so two in-process daemons (the
loopback test harness) never double-register one family.
"""

from __future__ import annotations

import bisect
import re
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "skyplane_"

#: default latency buckets (seconds): 100 us .. 30 s, log-ish spacing
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def sanitize_metric_name(name: str) -> str:
    name = _NAME_SANITIZE.sub("_", name)
    if not name.startswith(_PREFIX):
        name = _PREFIX + name
    return name


class Counter:
    """Monotonic counter. ``inc`` is locked — registry metrics sit on event
    paths (per chunk / per window), not per-byte hot loops."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: either ``set()`` by the owner or computed by a
    callback at scrape time (``fn``)."""

    __slots__ = ("name", "help", "fn", "_lock", "_value")

    def __init__(self, name: str, help_: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help_
        self.fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le`` bucket
    counts every observation <= its bound, plus ``+Inf``/``_sum``/``_count``)."""

    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_sum", "_count")

    def __init__(self, name: str, help_: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * len(self.buckets)  # per-bucket (non-cumulative) counts
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            if i < len(self._counts):
                self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum = []
        acc = 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, total, n

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1) with Prometheus
        ``histogram_quantile`` semantics: linear interpolation inside the
        bucket the rank lands in, lower edge 0 for the first bucket. Returns
        None when empty; a rank in the +Inf bucket returns the largest finite
        bound (the honest answer — the histogram cannot see past it). The
        SLO gates (soak_service, check_bench_json) read p50/p95 from here
        instead of keeping their own ad-hoc latency lists."""
        cum, _total, n = self.snapshot()
        if n <= 0:
            return None
        q = min(max(q, 0.0), 1.0)
        rank = q * n
        prev_cum, prev_edge = 0, 0.0
        for edge, c in zip(self.buckets, cum):
            if c >= rank:
                in_bucket = c - prev_cum
                if in_bucket <= 0:
                    return float(edge)
                frac = (rank - prev_cum) / in_bucket
                return prev_edge + (edge - prev_edge) * frac
            prev_cum, prev_edge = c, float(edge)
        return float(self.buckets[-1]) if self.buckets else None


class LabeledFamily:
    """A family of counters/gauges keyed by one label (e.g. ``tenant``):
    ``family.labels("ab12")`` returns the child metric, created on first use.
    Exposition renders one ``name{label="value"} v`` sample per child under a
    single HELP/TYPE header — the per-tenant accounting surface the
    multi-tenant gateway exports (docs/multitenancy.md)."""

    __slots__ = ("name", "help", "label", "kind", "_lock", "_children")

    def __init__(self, name: str, help_: str, label: str = "tenant", kind: str = "counter"):
        self.name = name
        self.help = help_
        self.label = label
        self.kind = kind  # "counter" | "gauge"
        self._lock = threading.Lock()
        self._children: "OrderedDict[str, object]" = OrderedDict()

    def labels(self, value: str):
        with self._lock:
            child = self._children.get(value)
            if child is None:
                cls = Counter if self.kind == "counter" else Gauge
                child = cls(self.name, self.help)
                self._children[value] = child
            return child

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            children = list(self._children.items())
        return [(v, c.value()) for v, c in children]


class MetricsRegistry:
    def __init__(self, parent: Optional["MetricsRegistry"] = None):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, object]" = OrderedDict()
        self._providers: List[Tuple[str, Callable[[], dict]]] = []
        self._labeled_providers: List[Tuple[str, str, Callable[[], dict]]] = []
        self.parent = parent

    # ---- native metrics (create-or-get: same name -> same instance) ----

    def _get_or_create(self, name: str, factory):
        name = sanitize_metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory(name)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda n: Counter(n, help_))

    def gauge(self, name: str, help_: str = "", fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(name, lambda n: Gauge(n, help_, fn=fn))

    def histogram(self, name: str, help_: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda n: Histogram(n, help_, buckets=buckets))

    def labeled_counter(self, name: str, help_: str = "", label: str = "tenant") -> LabeledFamily:
        return self._get_or_create(name, lambda n: LabeledFamily(n, help_, label=label, kind="counter"))

    def labeled_gauge(self, name: str, help_: str = "", label: str = "tenant") -> LabeledFamily:
        return self._get_or_create(name, lambda n: LabeledFamily(n, help_, label=label, kind="gauge"))

    # ---- absorbed legacy schemas ----

    def register_provider(self, prefix: str, fn: Callable[[], dict]) -> None:
        """Absorb a dict-returning counter source (the DATAPATH / DECODE /
        SENDER_WIRE schemas). Keys render as ``skyplane_<prefix>_<key>``;
        the provider is called at scrape time, so values are always live."""
        with self._lock:
            self._providers.append((prefix, fn))

    def register_labeled_provider(self, prefix: str, fn: Callable[[], dict], label="tenant") -> None:
        """Absorb a nested dict source ``{metric: {label_value: number}}``:
        each metric renders as ``skyplane_<prefix>_<metric>{<label>="v"} n``.
        This is how per-tenant accounting (TenantRegistry, scheduler, the
        persistent dedup index) reaches /api/v1/metrics.

        ``label`` may also be a tuple of label names, with the provider's
        inner keys being same-length tuples of values — the per-edge surface
        (``skyplane_egress_bytes_total{src="...",dst="..."}``) the blast
        fan-out accounting measures source egress from (docs/blast.md)."""
        with self._lock:
            self._labeled_providers.append((prefix, label, fn))

    # ---- exposition ----

    def render_prometheus(self) -> str:
        lines: List[str] = []
        seen: set = set()
        for reg in self._chain():
            with reg._lock:
                metrics = list(reg._metrics.values())
                providers = list(reg._providers)
                labeled_providers = list(reg._labeled_providers)
            for m in metrics:
                if m.name in seen:
                    continue
                seen.add(m.name)
                help_ = m.help or m.name
                if isinstance(m, LabeledFamily):
                    lines.append(f"# HELP {m.name} {help_}")
                    lines.append(f"# TYPE {m.name} {m.kind}")
                    for label_value, v in m.samples():
                        lines.append(f'{m.name}{{{m.label}="{_escape_label(label_value)}"}} {_fmt(v)}')
                elif isinstance(m, Histogram):
                    lines.append(f"# HELP {m.name} {help_}")
                    lines.append(f"# TYPE {m.name} histogram")
                    cum, total, n = m.snapshot()
                    for bound, c in zip(m.buckets, cum):
                        lines.append(f'{m.name}_bucket{{le="{_fmt(bound)}"}} {c}')
                    lines.append(f'{m.name}_bucket{{le="+Inf"}} {n}')
                    lines.append(f"{m.name}_sum {_fmt(total)}")
                    lines.append(f"{m.name}_count {n}")
                else:
                    kind = "counter" if isinstance(m, Counter) else "gauge"
                    lines.append(f"# HELP {m.name} {help_}")
                    lines.append(f"# TYPE {m.name} {kind}")
                    lines.append(f"{m.name} {_fmt(m.value())}")
            for prefix, fn in providers:
                try:
                    values = fn()
                except Exception:  # noqa: BLE001 — one broken provider must not kill the scrape
                    continue
                for key in sorted(values):
                    v = values[key]
                    if not isinstance(v, (int, float)) or isinstance(v, bool):
                        continue
                    name = sanitize_metric_name(f"{prefix}_{key}")
                    if name in seen:
                        continue
                    seen.add(name)
                    lines.append(f"# HELP {name} absorbed from the {prefix} counter schema")
                    lines.append(f"# TYPE {name} gauge")
                    lines.append(f"{name} {_fmt(v)}")
            for prefix, label, fn in labeled_providers:
                try:
                    families = fn()
                except Exception:  # noqa: BLE001 — one broken provider must not kill the scrape
                    continue
                for key in sorted(families):
                    by_label = families[key]
                    if not isinstance(by_label, dict):
                        continue
                    name = sanitize_metric_name(f"{prefix}_{key}")
                    if name in seen:
                        continue
                    seen.add(name)
                    label_names = (label,) if isinstance(label, str) else tuple(label)
                    lines.append(f"# HELP {name} per-{','.join(label_names)} value from the {prefix} provider")
                    lines.append(f"# TYPE {name} gauge")
                    for label_value in sorted(by_label):
                        v = by_label[label_value]
                        if not isinstance(v, (int, float)) or isinstance(v, bool):
                            continue
                        values = (label_value,) if not isinstance(label_value, tuple) else label_value
                        if len(values) != len(label_names):
                            continue  # malformed key: skip the sample, never the scrape
                        pairs = ",".join(
                            f'{n}="{_escape_label(str(v_))}"' for n, v_ in zip(label_names, values)
                        )
                        lines.append(f"{name}{{{pairs}}} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def _chain(self) -> List["MetricsRegistry"]:
        out: List[MetricsRegistry] = [self]
        reg = self.parent
        while reg is not None:
            out.append(reg)
            reg = reg.parent
        return out


def _fmt(v: float) -> str:
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def open_fd_count() -> int:
    """Open file descriptors of this process (the ``process_open_fds`` gauge;
    soak-leak signal — VERDICT next-round #8). -1 when /proc is unavailable."""
    try:
        import os

        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def thread_cpu_by_tid(task_dir: str = "/proc/self/task") -> Dict[int, float]:
    """Per-kernel-thread CPU seconds ``{tid: utime+stime}`` from
    ``/proc/self/task/<tid>/stat``. Empty when /proc is unavailable (macOS,
    sandboxes) — callers treat an empty map as a degraded CPU clock. This is
    the sampling profiler's on-CPU/off-CPU input (obs/profiler.py), kept
    separate from :func:`thread_cpu_seconds` so the sampler never pays the
    Python-thread name mapping per tick."""
    import os

    out: Dict[int, float] = {}
    try:
        tick = float(os.sysconf("SC_CLK_TCK"))
        tids = os.listdir(task_dir)
    except (OSError, ValueError, AttributeError):
        return out
    for tid_s in tids:
        try:
            with open(f"{task_dir}/{tid_s}/stat", "rb") as f:
                raw = f.read().decode(errors="replace")
            tid = int(tid_s)
        except (OSError, ValueError):
            continue  # thread exited between listdir and read / non-tid entry
        # comm may contain spaces/parens: fields 14/15 (utime/stime) are
        # counted from AFTER the last ')'
        rest = raw.rpartition(")")[2].split()
        if len(rest) < 13:
            continue
        out[tid] = (int(rest[11]) + int(rest[12])) / tick
    return out


def thread_cpu_seconds(task_dir: str = "/proc/self/task") -> Dict[str, dict]:
    """Per-thread CPU seconds of this process, keyed by Python thread name
    (``GET /api/v1/profile/cpu``; the bottleneck report's CPU-attribution
    input, docs/observability.md).

    Fallback ladder (each rung keeps the schema alive, tested in
    tests/unit/test_profiler.py):

      1. Linux: utime+stime per ``/proc/self/task/<tid>/stat`` via
         :func:`thread_cpu_by_tid`, tids mapped back to Python threads via
         ``Thread.native_id`` — the only way to observe EVERY thread's CPU
         clock, since ``time.thread_time()`` measures only its caller.
      2. ``native_id`` missing on a thread (exotic platforms / stub threads):
         its tid row survives as ``tid-<n>`` instead of vanishing.
      3. ``task_dir`` unreadable (no /proc at all): degrades to the calling
         thread's ``time.thread_time()`` so the schema never vanishes.
    """
    import threading
    import time

    by_tid = thread_cpu_by_tid(task_dir)
    if not by_tid:
        return {threading.current_thread().name: {"tid": -1, "cpu_s": round(time.thread_time(), 6)}}
    names: Dict[int, str] = {}
    for t in threading.enumerate():
        nid = getattr(t, "native_id", None)
        if nid is not None:
            names[nid] = t.name
    out: Dict[str, dict] = {}
    for tid in sorted(by_tid):
        name = names.get(tid, f"tid-{tid}")
        key = name if name not in out else f"{name}#{tid}"  # duplicate names stay distinct
        out[key] = {"tid": tid, "cpu_s": round(by_tid[tid], 6)}
    return out


# ---- process-wide singleton (long-lived components' histograms live here) ----

_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    r = _registry
    if r is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
            r = _registry
    return r
