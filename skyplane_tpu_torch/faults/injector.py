"""Seeded, deterministic fault injection for the data plane.

Chaos testing is only useful when a failure found at 03:00 can be replayed at
09:00: every fault decision here is a pure function of ``(plan.seed, point
name, evaluation index)``, so a chaos run's fault firing sequence is fully
determined by its :class:`FaultPlan` — re-running with the same seed injects
the same faults at the same evaluation points (per point; thread interleaving
may reorder *which chunk* hits a given evaluation index, never whether that
index fires).

Design constraints (mirrors the obs tracer, skyplane_tpu/obs/tracer.py):

  * **Disabled means free.** With ``SKYPLANE_TPU_FAULTS`` unset,
    :func:`get_injector` returns the shared :data:`NOOP_INJECTOR` whose
    ``enabled`` is False — hot paths guard every injection site with one
    attribute check and never call into the decision machinery.
  * **Named points, armed by plan.** A fault point compiled into a hot path
    (``inj.check("sender.send")``) does nothing unless the active plan arms
    that name. The full catalog lives in docs/fault-injection.md.
  * **Accounted, never silent.** Every firing bumps a per-point counter
    (exported as ``skyplane_faults_injected{point=...}`` on
    ``/api/v1/metrics``), lands in a bounded firing log, and emits a trace
    span when the tracer is on — a chaos timeline is debuggable after the
    fact.

Plan JSON (file path or inline JSON in ``SKYPLANE_TPU_FAULTS``)::

    {"seed": 1337,
     "points": {
       "sender.send":    {"p": 0.05},
       "receiver.recv":  {"p": 1.0, "after": 20, "max_fires": 3}
     }}

``p``          probability a given evaluation fires (drawn from the point's
               seeded stream — deterministic in evaluation order).
``after``      evaluations to skip before the point may fire (lets a plan
               target steady state instead of the first connect).
``max_fires``  total firing budget (None/omitted = unlimited).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

FAULTS_ENV = "SKYPLANE_TPU_FAULTS"
MAX_FIRING_LOG = 4096  # (seq, point, eval_index) entries; oldest dropped


@dataclass(frozen=True)
class FaultSpec:
    """Arming parameters for one named fault point."""

    p: float = 1.0
    after: int = 0
    max_fires: Optional[int] = None

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        return FaultSpec(
            p=max(0.0, min(1.0, float(d.get("p", 1.0)))),
            after=max(0, int(d.get("after", 0))),
            max_fires=None if d.get("max_fires") is None else max(0, int(d["max_fires"])),
        )

    def as_dict(self) -> dict:
        out: dict = {"p": self.p, "after": self.after}
        if self.max_fires is not None:
            out["max_fires"] = self.max_fires
        return out


@dataclass(frozen=True)
class FaultPlan:
    """A seed plus the set of armed points — the complete, publishable
    description of a chaos run (same plan => same firing schedule)."""

    seed: int
    points: Dict[str, FaultSpec]

    @staticmethod
    def from_dict(d: dict) -> "FaultPlan":
        pts = d.get("points") or {}
        if not isinstance(pts, dict):
            raise ValueError("FaultPlan 'points' must be a {name: spec} object")
        return FaultPlan(
            seed=int(d.get("seed", 0)),
            points={str(name): FaultSpec.from_dict(spec or {}) for name, spec in pts.items()},
        )

    @staticmethod
    def from_env_value(value: str) -> "FaultPlan":
        """Parse the ``SKYPLANE_TPU_FAULTS`` value: inline JSON (starts with
        ``{``) or a path to a JSON plan file."""
        value = value.strip()
        raw = value if value.startswith("{") else open(value).read()
        return FaultPlan.from_dict(json.loads(raw))

    def as_dict(self) -> dict:
        return {"seed": self.seed, "points": {k: v.as_dict() for k, v in sorted(self.points.items())}}


def _point_rng(seed: int, point: str) -> random.Random:
    """The point's private decision stream — independent of every other
    point, so arming a new point never perturbs an existing schedule."""
    return random.Random(f"{seed}:{point}")


def decision_schedule(seed: int, point: str, spec: FaultSpec, n_evals: int) -> List[int]:
    """The evaluation indices (0-based) at which this point fires over its
    first ``n_evals`` evaluations — a pure replay of the injector's decisions,
    used by tests and the chaos soak to PROVE seed determinism without
    re-running the workload."""
    rng = _point_rng(seed, point)
    fires: List[int] = []
    for i in range(n_evals):
        draw = rng.random()
        if i < spec.after:
            continue
        if spec.max_fires is not None and len(fires) >= spec.max_fires:
            break
        if draw < spec.p:
            fires.append(i)
    return fires


class _PointState:
    __slots__ = ("spec", "rng", "evals", "fires", "lock")

    def __init__(self, spec: FaultSpec, seed: int, name: str):
        self.spec = spec
        self.rng = _point_rng(seed, name)
        self.evals = 0
        self.fires = 0
        self.lock = threading.Lock()


class FaultInjector:
    """Live decision engine for one :class:`FaultPlan`."""

    enabled = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._points = {name: _PointState(spec, plan.seed, name) for name, spec in plan.points.items()}
        self._log: List[Tuple[int, str, int]] = []  # (global seq, point, eval index)
        self._log_lock = threading.Lock()
        self._seq = 0

    # ---- decision core ----

    def fire(self, point: str) -> bool:
        """Evaluate one arrival at ``point``; True when the fault fires.
        Unarmed points return False without consuming any randomness."""
        return self._fire(point) is not None

    def _fire(self, point: str) -> Optional[int]:
        """The decision core: returns the firing's evaluation index, or None
        when the point does not fire — derived fault parameters (corruption
        positions) key off that index so they replay regardless of which
        thread's arrival claimed it."""
        st = self._points.get(point)
        if st is None:
            return None
        with st.lock:
            i = st.evals
            st.evals = i + 1
            draw = st.rng.random()  # always consumed: eval index == draw index
            if i < st.spec.after:
                return None
            if st.spec.max_fires is not None and st.fires >= st.spec.max_fires:
                return None
            if draw >= st.spec.p:
                return None
            st.fires += 1
        self._record(point, i)
        return i

    def _record(self, point: str, eval_index: int) -> None:
        with self._log_lock:
            self._seq += 1
            seq = self._seq
            self._log.append((seq, point, eval_index))
            if len(self._log) > MAX_FIRING_LOG:
                del self._log[: len(self._log) - MAX_FIRING_LOG]
        # a chaos timeline is debuggable: firings land on the trace alongside
        # the spans of the work they disrupted (docs/fault-injection.md)
        from skyplane_tpu_torch.obs import get_recorder, get_tracer

        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_span(f"fault.{point}", 0, time.time_ns(), cat="fault", args={"eval": eval_index, "seq": seq})
        # ... and on the flight recorder, so the fleet event log interleaves
        # firings with the recoveries they triggered (docs/observability.md)
        from skyplane_tpu_torch.obs.events import EV_FAULT_FIRED

        get_recorder().record(EV_FAULT_FIRED, point=point, eval=eval_index, fault_seq=seq)

    # ---- injection helpers (hot-path API) ----

    def check(self, point: str, exc: type = OSError, msg: str = "") -> None:
        """Raise ``exc`` when the point fires (socket errors, decode faults,
        control-API failures all reduce to "this call raises here")."""
        if self.fire(point):
            raise exc(msg or f"injected fault at {point}")

    def corrupt(self, point: str, data: bytes) -> bytes:
        """Flip one deterministic byte of ``data`` when the point fires
        (frame-payload corruption: exercises CRC/codec/NACK recovery)."""
        if not data:
            return data
        i = self._fire(point)
        if i is None:
            return data
        # position is a pure function of (seed, point, eval index): replayable
        # even when concurrent threads race their firings, and it never
        # consumes the decision stream schedule() replays
        pos = _point_rng(self.plan.seed, f"{point}:pos:{i}").randrange(len(data))
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)

    # ---- accounting ----

    def counters(self) -> Dict[str, int]:
        """{point: firings} — the ``faults_injected`` metrics family."""
        return {name: st.fires for name, st in sorted(self._points.items()) if st.fires}

    def eval_counts(self) -> Dict[str, int]:
        return {name: st.evals for name, st in sorted(self._points.items())}

    def firing_log(self) -> List[Tuple[int, str, int]]:
        with self._log_lock:
            return list(self._log)

    def schedule(self, point: str, n_evals: int) -> List[int]:
        """Replay this plan's decision schedule for one point (see
        :func:`decision_schedule`)."""
        spec = self.plan.points.get(point)
        if spec is None:
            return []
        return decision_schedule(self.plan.seed, point, spec, n_evals)


class _NoopInjector:
    """Shared do-nothing injector: faults disarmed, near-zero hot-path cost
    (call sites guard on ``enabled`` and never reach these methods)."""

    enabled = False
    __slots__ = ()
    plan = None

    def fire(self, point: str) -> bool:
        return False

    def check(self, point: str, exc: type = OSError, msg: str = "") -> None:
        return None

    def corrupt(self, point: str, data: bytes) -> bytes:
        return data

    def counters(self) -> Dict[str, int]:
        return {}

    def eval_counts(self) -> Dict[str, int]:
        return {}

    def firing_log(self) -> List[Tuple[int, str, int]]:
        return []

    def schedule(self, point: str, n_evals: int) -> List[int]:
        return []


NOOP_INJECTOR = _NoopInjector()

# ---- process-wide singleton (the obs tracer idiom) ----

_injector = None
_injector_lock = threading.Lock()


def _from_env():
    raw = os.environ.get(FAULTS_ENV, "").strip()
    if not raw or raw in ("0", "off", "false"):
        return NOOP_INJECTOR
    try:
        return FaultInjector(FaultPlan.from_env_value(raw))
    except (OSError, ValueError, json.JSONDecodeError) as e:
        from skyplane_tpu_torch.utils.logger import logger

        logger.fs.warning(f"ignoring malformed {FAULTS_ENV} ({e}); fault injection stays off")
        return NOOP_INJECTOR


def get_injector():
    global _injector
    inj = _injector
    if inj is None:
        with _injector_lock:
            if _injector is None:
                _injector = _from_env()
            inj = _injector
    return inj


def configure_injector(plan: Optional[FaultPlan]):
    """Install (or with ``None``, re-read the environment for) the process
    injector — tests and the chaos soak arm plans programmatically."""
    global _injector
    with _injector_lock:
        _injector = FaultInjector(plan) if plan is not None else _from_env()
        return _injector
