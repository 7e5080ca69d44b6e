"""Always-on sampling profiler + GIL-contention probe (core-time attribution).

PR 9's telemetry plane answers "where did a chunk's *wall* time go"; ROADMAP
item 1 needs the harder question answered before the multi-core pump refactor
is judged: where does each CORE's time go, and is the wire stack GIL-bound,
lock-bound, or genuinely parallel? This module is that instrument:

  * **Sampling profiler** (:class:`StackProfiler`): a dedicated daemon thread
    walks ``sys._current_frames()`` at ``SKYPLANE_TPU_PROFILE_HZ`` and folds
    each thread's stack into bounded per-thread tables. Every sample is
    classified into the existing stage taxonomy (frame / send_stall /
    ack_lag / decode / store / device_wait, plus codec / crypto / framing
    sub-buckets) by the innermost recognizable frame; per-thread CPU-clock
    deltas (``/proc/self/task`` via
    :func:`skyplane_tpu_torch.obs.metrics.thread_cpu_by_tid`) split samples into
    on-CPU vs off-CPU and convert sample counts into per-stage CPU
    *seconds*.
  * **GIL probe** (:class:`GilProbe`): a calibrated heartbeat thread whose
    scheduling-latency distribution yields ``gil_wait_fraction`` — the
    fraction of runnable time a Python thread spends waiting to reacquire
    the GIL. Cross-checked against the CPU-clock identity
    ``1 - cores_effective / runnable_threads`` so a miscalibrated probe is
    visible, never silently trusted.
  * **Export**: folded stacks (Brendan-Gregg collapsed format) and
    speedscope JSON (https://www.speedscope.app) behind
    ``GET /api/v1/profile/stacks``; a compact ``summary()`` rides the
    combined ``/api/v1/telemetry`` scrape so the collector's core-budget
    table costs no extra round trip.

Cost model (the <2% sampling-overhead gate in scripts/check_bench_json.py):
the per-tick work is ONLY the frame walk — frame info is cached per code
object and stage classification per (module, function) pair, so a steady
workload's tick cost is a dict-hit loop. The expensive part (one /proc read
per kernel thread) runs on its own ~10 Hz refresh cadence
(``cpu_refresh_s``); each refresh distributes the window's per-thread CPU
delta across that window's samples proportionally, so per-stage CPU seconds
still sum to the process CPU clock while the sampler itself stays cheap
enough to leave on.

Design constraints (the tracer/injector conventions, obs/tracer.py):

  * **Disabled means free.** ``SKYPLANE_TPU_PROFILE_HZ`` unset/0 ⇒
    :func:`get_profiler` returns the shared :data:`NOOP_PROFILER`: no
    thread, no allocation, every accessor returns a cached empty value.
  * **Bounded memory, loud truncation.** Per-thread folded-stack tables cap
    at ``max_stacks`` unique stacks (overflow folds into a ``(truncated)``
    bucket and bumps ``profile_stacks_truncated``); dead threads retire into
    a bounded list (newest :data:`MAX_RETIRED_TRACKS`), older retirees fold
    into aggregate totals — per-thread identity is lost but no sample is.
    A delayed or dropped sampler tick bumps ``profile_samples_dropped``
    (the ``profile.sample_stall`` fault point proves this degradation is
    loud, docs/fault-injection.md).
  * **No merged tracks.** A track is keyed by the *Thread object*, not the
    OS ident: idents recycle under the gateway's per-connection thread
    churn, and merging two threads' stacks would mis-attribute whole stages.
  * **The walk takes no locks.** ``sys._current_frames()`` is snapshotted
    and folded into LOCAL rows first; the profiler lock is taken only for
    the final merge, and no non-local callback runs inside the walk — the
    ``frame-walk-under-lock`` lint rule (docs/static-analysis.md) gates
    this whole bug class (a sampler that deadlocks the process it profiles).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

PROFILE_HZ_ENV = "SKYPLANE_TPU_PROFILE_HZ"
PROFILE_STACKS_ENV = "SKYPLANE_TPU_PROFILE_MAX_STACKS"
DEFAULT_MAX_STACKS = 256  # unique folded stacks retained per thread track
MAX_RETIRED_TRACKS = 32  # dead-thread tables kept whole; older ones fold into totals
MAX_DEPTH = 48  # frames kept per stack, innermost first
DEFAULT_CPU_REFRESH_S = 0.1  # per-thread CPU clock cadence (see module docstring)
_CODE_CACHE_MAX = 8192  # (code object -> (module, func)) entries before reset

#: the full classification axis: the six bottleneck stages bench.py and the
#: collector already attribute wall time to (obs/collector.py STAGE_SPANS),
#: plus the codec/crypto/framing sub-buckets CPU time actually burns in, plus
#: the unattributed remainder. check_bench_json.py requires every key.
PROFILE_STAGES = (
    "frame",
    "send_stall",
    "ack_lag",
    "decode",
    "store",
    "device_wait",
    "codec",
    "crypto",
    "framing",
    "other",
)

# (module basename, function-name prefix ('' = any), stage) — evaluated
# innermost frame outward, first match wins, so a pump thread currently
# inside zstd classifies as codec, not frame. Off-CPU samples whose innermost
# match is the sender pump ("frame") reclassify as send_stall: a blocked pump
# is by definition waiting on window/ack credit, not framing.
_STAGE_MARKERS: Tuple[Tuple[str, str, str], ...] = (
    ("codecs.py", "", "codec"),
    ("blockpack.py", "", "codec"),
    ("lz4ref.py", "", "codec"),
    ("host_fallback.py", "", "codec"),
    ("crypto.py", "", "crypto"),
    ("ssl.py", "", "crypto"),
    ("chunk.py", "", "framing"),
    ("pipeline.py", "restore", "decode"),
    ("pipeline.py", "", "frame"),
    ("fused_cdc.py", "", "frame"),
    ("cdc.py", "", "frame"),
    ("fingerprint.py", "", "frame"),
    ("gear.py", "", "frame"),
    ("dedup.py", "", "store"),
    ("chunk_store.py", "", "store"),
    ("batch_runner.py", "", "device_wait"),
    ("sender_wire.py", "_drain_acks", "ack_lag"),
    ("sender_wire.py", "", "frame"),
    ("gateway_receiver.py", "_recv_exact", "framing"),
    ("gateway_receiver.py", "_conn_loop", "framing"),
    ("gateway_receiver.py", "_drain_responses", "framing"),
    ("gateway_receiver.py", "", "decode"),
)

# (module, func) -> stage-or-None memo: marker matching runs once per unique
# frame, not once per frame per tick. Bounded by the program's code size.
_frame_stage_cache: Dict[Tuple[str, str], Optional[str]] = {}


def _frame_stage(mod: str, func: str) -> Optional[str]:
    key = (mod, func)
    hit = _frame_stage_cache.get(key, _frame_stage_cache)
    if hit is not _frame_stage_cache:
        return hit
    stage: Optional[str] = None
    for marker_mod, marker_func, marker_stage in _STAGE_MARKERS:
        if mod == marker_mod and (not marker_func or func.startswith(marker_func)):
            stage = marker_stage
            break
    _frame_stage_cache[key] = stage
    return stage


def classify_frames(frames: Sequence[Tuple[str, str]], on_cpu: bool = True) -> str:
    """Stage of one folded stack (``[(module_basename, func), ...]``,
    innermost first). Pure function — the sampler calls it inside the walk,
    so it must never touch shared state or invoke callbacks."""
    for mod, func in frames:
        stage = _frame_stage(mod, func)
        if stage is not None:
            if stage == "frame" and not on_cpu:
                return "send_stall"
            return stage
    return "other"


# ------------------------------------------------------------------ GIL probe


class GilProbe:
    """Calibrated heartbeat: sleep a short tick, measure the overshoot.

    On an idle interpreter the overshoot is timer slack (a fixed floor this
    probe *calibrates out* by tracking the minimum observed overshoot); under
    GIL contention the heartbeat additionally waits its turn for the GIL
    after the OS wakes it, and that excess — averaged over a bounded window —
    is the per-wakeup GIL wait. ``fraction()`` converts it to the share of
    runnable time spent waiting: ``excess / (tick + excess)``."""

    def __init__(self, tick_s: float = 0.005, window: int = 1024):
        self.tick_s = max(0.001, float(tick_s))
        self._lock = threading.Lock()
        self._lat: "deque[float]" = deque(maxlen=max(16, int(window)))
        self._baseline = float("inf")  # minimum overshoot ever seen = timer slack
        self._beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(target=self._run, name="profile-gil-probe", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.tick_s * 10 + 1.0)
        with self._lock:
            self._thread = None
        self._stop.clear()

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self._stop.wait(self.tick_s)
            overshoot = max(0.0, time.perf_counter() - t0 - self.tick_s)
            with self._lock:
                self._beats += 1
                self._lat.append(overshoot)
                if overshoot < self._baseline:
                    self._baseline = overshoot

    def fraction(self) -> float:
        """Fraction of runnable time the heartbeat spent waiting (0..1);
        0.0 until enough beats landed to calibrate."""
        with self._lock:
            lat = list(self._lat)
            baseline = self._baseline
        if len(lat) < 8 or baseline == float("inf"):
            return 0.0
        excess = sum(max(0.0, v - baseline) for v in lat) / len(lat)
        return min(1.0, excess / (self.tick_s + excess))

    def stats(self) -> dict:
        with self._lock:
            n = len(self._lat)
            baseline = 0.0 if self._baseline == float("inf") else self._baseline
            beats = self._beats
        return {
            "beats": beats,
            "window": n,
            "tick_ms": round(self.tick_s * 1e3, 3),
            "baseline_us": round(baseline * 1e6, 1),
            "fraction": round(self.fraction(), 4),
        }


# ------------------------------------------------------------------- profiler


class _Track:
    """One thread's bounded sample table. Keyed by the Thread OBJECT (ident
    recycling must never merge two threads' stacks into one track)."""

    __slots__ = (
        "key",
        "name",
        "ident",
        "thread",
        "samples",
        "on_cpu_weight",
        "stages",
        "stacks",
        "stacks_truncated",
        "last_cpu_s",
        "cpu_s",
        "last_on_frac",
        "window_stages",
    )

    def __init__(self, key: str, name: str, ident: int, thread: Optional[threading.Thread]):
        self.key = key
        self.name = name
        self.ident = ident
        self.thread = thread
        self.samples = 0
        self.on_cpu_weight = 0.0
        # stage -> [sample_weight, cpu_seconds]
        self.stages: Dict[str, List[float]] = {}
        self.stacks: Dict[tuple, int] = {}
        self.stacks_truncated = 0
        self.last_cpu_s: Optional[float] = None
        self.cpu_s = 0.0
        # last CPU-refresh window's on-CPU fraction: the (slightly stale, at
        # most cpu_refresh_s old) classifier input for on-CPU vs off-CPU
        self.last_on_frac = 1.0
        self.window_stages: Dict[str, int] = {}  # samples per stage since last refresh


#: the folded-stack key samples land on when a track's unique-stack table is
#: full — truncation stays visible in every export instead of dropping bytes
_TRUNCATED_STACK = (("(truncated)", "(truncated)"),)


class StackProfiler:
    """Sampling profiler (see module docstring). ``hz <= 0`` constructs a
    disabled instance; prefer :data:`NOOP_PROFILER` via :func:`get_profiler`
    so disabled costs nothing at all."""

    enabled = True

    def __init__(
        self,
        hz: float = 0.0,
        max_stacks: int = DEFAULT_MAX_STACKS,
        label: str = "skyplane-tpu",
        cpu_refresh_s: float = DEFAULT_CPU_REFRESH_S,
    ):
        self.hz = max(0.0, float(hz))
        self.enabled = self.hz > 0.0
        self.max_stacks = max(16, int(max_stacks))
        self.label = label
        self.cpu_refresh_s = max(0.0, float(cpu_refresh_s))
        self._lock = threading.Lock()
        self._tracks: Dict[int, _Track] = {}  # live, keyed by ident
        self._retired: List[_Track] = []
        self._retired_folded_samples = 0
        self._retired_folded_cpu_s = 0.0
        self._retired_folded_stages: Dict[str, List[float]] = {}
        self._retired_total = 0
        self._track_seq = 0
        self._samples = 0
        self._dropped = 0
        self._stacks_truncated = 0
        self._wall_s = 0.0
        self._cpu_s = 0.0
        self._runnable_sum = 0.0
        self._refreshes = 0
        self._cpu_clock_ok = True
        self._last_sample_t: Optional[float] = None
        self._last_refresh_t: Optional[float] = None
        self._code_info: Dict[object, Tuple[str, str]] = {}  # code object -> (module, func)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.gil_probe = GilProbe()

    # ---- lifecycle ----

    def ensure_started(self) -> bool:
        """Start the sampler + GIL probe threads (idempotent). Returns True
        when the profiler is running after the call."""
        if not self.enabled:
            return False
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="profile-sampler", daemon=True)
                self._thread.start()
        self.gil_probe.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0 + (1.0 / self.hz if self.hz else 0.0))
        with self._lock:
            self._thread = None
        self._stop.clear()
        self.gil_probe.stop()

    def _run(self) -> None:
        period = 1.0 / self.hz
        next_t = time.perf_counter() + period
        while not self._stop.wait(max(0.0, next_t - time.perf_counter())):
            self.sample_once()
            next_t += period
            behind = time.perf_counter() - next_t
            if behind > period:
                # the tick stalled (GC pause, an overloaded box): skip the
                # missed slots and COUNT them — a profile that silently
                # stretched its sample spacing would understate every rate
                missed = int(behind / period)
                with self._lock:
                    self._dropped += missed
                next_t += missed * period

    # ---- sampling ----

    def sample_once(self) -> int:
        """Take one sample of every Python thread. Returns threads sampled
        (0 when the tick was dropped by the ``profile.sample_stall`` fault
        point — the degradation stays loud via ``profile_samples_dropped``)."""
        from skyplane_tpu_torch.faults import get_injector

        inj = get_injector()
        if inj.enabled and inj.fire("profile.sample_stall"):
            with self._lock:
                self._dropped += 1
            return 0
        now = time.perf_counter()
        cpu_by_tid: Optional[Dict[int, float]] = None
        if self._last_refresh_t is None or now - self._last_refresh_t >= self.cpu_refresh_s:
            from skyplane_tpu_torch.obs.metrics import thread_cpu_by_tid

            cpu_by_tid = thread_cpu_by_tid()
        # snapshot first, then fold into LOCAL rows: the walk holds no lock
        # and invokes nothing non-local (the frame-walk-under-lock contract)
        frames_snap = sys._current_frames()
        live: Dict[int, threading.Thread] = {}
        for t in threading.enumerate():
            if t.ident is not None:
                live[t.ident] = t
        # the sampler never profiles its own machinery: skip the sampler
        # thread (covers the normal in-loop invocation; a direct caller —
        # tests, the bench overhead loop — is a legitimate target) and the
        # GIL heartbeat it calibrates with
        sampler_thread = self._thread
        skip_ident = sampler_thread.ident if sampler_thread is not None else None
        probe_thread = self.gil_probe._thread
        code_info = self._code_info
        if len(code_info) > _CODE_CACHE_MAX:
            code_info = self._code_info = {}
        rows: List[Tuple[int, tuple]] = []
        for ident, top in frames_snap.items():
            if ident == skip_ident:
                continue
            t = live.get(ident)
            if probe_thread is not None and t is probe_thread:
                continue
            stack: List[Tuple[str, str]] = []
            f = top
            depth = 0
            while f is not None and depth < MAX_DEPTH:
                code = f.f_code
                info = code_info.get(code)
                if info is None:
                    info = (os.path.basename(code.co_filename), code.co_name)
                    code_info[code] = info
                stack.append(info)
                f = f.f_back
                depth += 1
            rows.append((ident, tuple(stack)))
        with self._lock:
            self._merge_tick_locked(now, rows, live, cpu_by_tid)
        return len(rows)

    def _merge_tick_locked(
        self,
        now: float,
        rows: List[Tuple[int, tuple]],
        live: Dict[int, threading.Thread],
        cpu_by_tid: Optional[Dict[int, float]],
    ) -> None:
        dt = 0.0
        if self._last_sample_t is not None:
            dt = max(0.0, now - self._last_sample_t)
        elif self.hz > 0:
            dt = 1.0 / self.hz
        self._last_sample_t = now
        sampled_idents = set()
        for ident, stack in rows:
            sampled_idents.add(ident)
            track = self._track_locked(ident, live.get(ident))
            stage = classify_frames(stack, on_cpu=track.last_on_frac >= 0.5)
            track.samples += 1
            track.on_cpu_weight += track.last_on_frac
            row = track.stages.setdefault(stage, [0.0, 0.0])
            row[0] += 1.0
            track.window_stages[stage] = track.window_stages.get(stage, 0) + 1
            if stack not in track.stacks and len(track.stacks) >= self.max_stacks:
                track.stacks_truncated += 1
                self._stacks_truncated += 1
                stack = _TRUNCATED_STACK
            track.stacks[stack] = track.stacks.get(stack, 0) + 1
            self._samples += 1
        self._wall_s += dt
        if cpu_by_tid is not None:
            self._refresh_cpu_locked(now, live, cpu_by_tid)
        # threads that vanished since the last tick retire NOW, while their
        # Thread object still distinguishes them from an ident-recycled
        # successor (no merged tracks — the test contract)
        for ident in [i for i in self._tracks if i not in sampled_idents]:
            self._retire_locked(ident)

    def _refresh_cpu_locked(self, now: float, live: Dict[int, threading.Thread], cpu_by_tid: Dict[int, float]) -> None:
        """Distribute each thread's CPU-clock delta since the last refresh
        across the window's samples (proportionally per stage), so per-stage
        CPU seconds sum to the process CPU clock at refresh granularity."""
        if not cpu_by_tid:
            self._cpu_clock_ok = False
        window_dt = 0.0
        if self._last_refresh_t is not None:
            window_dt = max(0.0, now - self._last_refresh_t)
        self._last_refresh_t = now
        runnable = 0
        for track in self._tracks.values():
            tid = getattr(track.thread, "native_id", None)
            cpu_now = cpu_by_tid.get(tid) if tid is not None else None
            if cpu_now is None:
                track.window_stages = {}
                continue
            delta = 0.0
            if track.last_cpu_s is not None and window_dt > 0:
                delta = min(max(0.0, cpu_now - track.last_cpu_s), window_dt)
            track.last_cpu_s = cpu_now
            if delta > 0:
                runnable += 1
            self._cpu_s += delta
            track.cpu_s += delta
            track.last_on_frac = min(1.0, delta / window_dt) if window_dt > 0 else 1.0
            total = sum(track.window_stages.values())
            if total and delta > 0:
                for stage, count in track.window_stages.items():
                    row = track.stages.setdefault(stage, [0.0, 0.0])
                    row[1] += delta * count / total
            track.window_stages = {}
        if window_dt > 0:
            self._runnable_sum += max(1, runnable)
            self._refreshes += 1

    def _track_locked(self, ident: int, thread: Optional[threading.Thread]) -> _Track:
        track = self._tracks.get(ident)
        if track is not None and thread is not None and track.thread is not None and track.thread is not thread:
            self._retire_locked(ident)  # recycled ident: never merge tracks
            track = None
        if track is None:
            self._track_seq += 1
            name = thread.name if thread is not None else f"tid-{ident}"
            track = _Track(f"{name}#{self._track_seq}", name, ident, thread)
            self._tracks[ident] = track
        return track

    def _retire_locked(self, ident: int) -> None:
        track = self._tracks.pop(ident, None)
        if track is None:
            return
        self._retired_total += 1
        self._retired.append(track)
        overflow = len(self._retired) - MAX_RETIRED_TRACKS
        for old in self._retired[: max(0, overflow)]:
            # beyond the bound only the totals survive (tracer ring idiom)
            self._retired_folded_samples += old.samples
            self._retired_folded_cpu_s += old.cpu_s
            for stage, (w, cpu) in old.stages.items():
                row = self._retired_folded_stages.setdefault(stage, [0.0, 0.0])
                row[0] += w
                row[1] += cpu
        if overflow > 0:
            del self._retired[:overflow]

    # ---- accounting / export ----

    def counters(self) -> dict:
        with self._lock:
            return {
                "profile_hz": self.hz,
                "profile_samples": self._samples,
                "profile_samples_dropped": self._dropped,
                "profile_threads": len(self._tracks),
                "profile_retired_threads": self._retired_total,
                "profile_stacks_truncated": self._stacks_truncated,
                "profile_gil_wait_fraction": round(self.gil_probe.fraction(), 4),
            }

    def _all_tracks_locked(self) -> List[_Track]:
        return list(self._tracks.values()) + list(self._retired)

    def summary(self) -> dict:
        """Compact core-budget payload (rides /api/v1/telemetry): per-stage
        CPU seconds + sample weights, ``gil_wait_fraction`` (probe, with the
        CPU-identity cross-check), ``cores_effective``, per-thread rollups."""
        probe_frac = self.gil_probe.fraction()
        with self._lock:
            tracks = self._all_tracks_locked()
            stage_cpu = {s: 0.0 for s in PROFILE_STAGES}
            stage_weight = {s: 0.0 for s in PROFILE_STAGES}
            for track in tracks:
                for stage, (w, cpu) in track.stages.items():
                    stage_cpu[stage] = stage_cpu.get(stage, 0.0) + cpu
                    stage_weight[stage] = stage_weight.get(stage, 0.0) + w
            for stage, (w, cpu) in self._retired_folded_stages.items():
                stage_cpu[stage] = stage_cpu.get(stage, 0.0) + cpu
                stage_weight[stage] = stage_weight.get(stage, 0.0) + w
            wall = self._wall_s
            cores = (self._cpu_s / wall) if wall > 0 else 0.0
            runnable = (self._runnable_sum / self._refreshes) if self._refreshes else 0.0
            expected = max(0.0, 1.0 - cores / runnable) if runnable >= 1.0 else 0.0
            threads = sorted(tracks, key=lambda tr: -tr.samples)[:16]
            return {
                "enabled": self.enabled,
                "hz": self.hz,
                "pid": os.getpid(),
                "samples": self._samples,
                "samples_dropped": self._dropped,
                "wall_s": round(wall, 3),
                "cpu_s": round(self._cpu_s, 4),
                "cores_effective": round(cores, 3),
                "runnable_threads": round(runnable, 2),
                "cpu_clock": "task" if self._cpu_clock_ok else "degraded",
                # probe value is authoritative; the CPU-clock identity rides
                # along so a drifted calibration is visible in every scrape
                "gil_wait_fraction": round(probe_frac, 4),
                "gil_wait_expected": round(expected, 4),
                "gil_probe": self.gil_probe.stats(),
                "stage_cpu_s": {s: round(v, 4) for s, v in stage_cpu.items()},
                "stage_samples": {s: round(v, 1) for s, v in stage_weight.items()},
                "threads": [
                    {
                        "name": tr.key,
                        "samples": tr.samples,
                        "cpu_s": round(tr.cpu_s, 4),
                        "on_cpu_frac": round(tr.on_cpu_weight / tr.samples, 3) if tr.samples else 0.0,
                    }
                    for tr in threads
                ],
                "retired_threads": self._retired_total,
                "stacks_truncated": self._stacks_truncated,
            }

    def cpu_breakdown(self) -> dict:
        """The bench deliverable (check_bench_json.py ``cpu_breakdown``):
        per-stage CPU seconds over the profiled window, the GIL wait
        fraction, and how many cores the process effectively used."""
        s = self.summary()
        return {
            "stage_cpu_s": s["stage_cpu_s"],
            "gil_wait_fraction": s["gil_wait_fraction"],
            "gil_wait_expected": s["gil_wait_expected"],
            "cores_effective": s["cores_effective"],
            "runnable_threads": s["runnable_threads"],
            "cpu_clock": s["cpu_clock"],
            "profile_hz": s["hz"],
            "profile_samples": s["samples"],
            "profile_samples_dropped": s["samples_dropped"],
            "wall_s": s["wall_s"],
        }

    def folded(self) -> List[str]:
        """Collapsed-stack lines (``thread;root;...;leaf count``) — feed to
        any flamegraph tool, or read the hot paths straight off the counts."""
        with self._lock:
            tracks = self._all_tracks_locked()
            out: List[str] = []
            for track in tracks:
                for stack, count in sorted(track.stacks.items(), key=lambda kv: -kv[1]):
                    frames = ";".join(f"{mod}:{func}" for mod, func in reversed(stack))
                    out.append(f"{track.key};{frames} {count}")
        return out

    def speedscope(self) -> dict:
        """speedscope JSON (one "sampled" profile per thread track, shared
        frame table) — drop the file on https://www.speedscope.app."""
        with self._lock:
            tracks = self._all_tracks_locked()
            frame_index: Dict[Tuple[str, str], int] = {}
            frames: List[dict] = []
            profiles: List[dict] = []
            for track in tracks:
                samples: List[List[int]] = []
                weights: List[int] = []
                for stack, count in sorted(track.stacks.items(), key=lambda kv: -kv[1]):
                    idxs: List[int] = []
                    for mod, func in reversed(stack):  # speedscope wants root -> leaf
                        i = frame_index.get((mod, func))
                        if i is None:
                            i = len(frames)
                            frame_index[(mod, func)] = i
                            frames.append({"name": f"{func} ({mod})", "file": mod})
                        idxs.append(i)
                    samples.append(idxs)
                    weights.append(count)
                profiles.append(
                    {
                        "type": "sampled",
                        "name": track.key,
                        "unit": "none",
                        "startValue": 0,
                        "endValue": sum(weights),
                        "samples": samples,
                        "weights": weights,
                    }
                )
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": self.label,
            "exporter": "skyplane-tpu-profiler",
            "shared": {"frames": frames},
            "profiles": profiles,
        }

    def reset(self) -> None:
        """Drop every table and counter (bench rep / test isolation); the
        sampler and probe threads keep running if started."""
        with self._lock:
            self._tracks.clear()
            self._retired.clear()
            self._retired_folded_samples = 0
            self._retired_folded_cpu_s = 0.0
            self._retired_folded_stages = {}
            self._retired_total = 0
            self._samples = 0
            self._dropped = 0
            self._stacks_truncated = 0
            self._wall_s = 0.0
            self._cpu_s = 0.0
            self._runnable_sum = 0.0
            self._refreshes = 0
            self._cpu_clock_ok = True
            self._last_sample_t = None
            self._last_refresh_t = None


class _NoopProfiler:
    """Shared disabled profiler: no thread, no tables, cached empty returns
    (mirrors NOOP_INJECTOR / NOOP_SPAN — disabled means free)."""

    enabled = False
    hz = 0.0
    __slots__ = ()

    _EMPTY_SUMMARY = {
        "enabled": False,
        "hz": 0.0,
        "samples": 0,
        "samples_dropped": 0,
        "gil_wait_fraction": 0.0,
        "cores_effective": 0.0,
        "stage_cpu_s": {},
        "threads": [],
    }
    _EMPTY_COUNTERS = {"profile_hz": 0.0, "profile_samples": 0, "profile_samples_dropped": 0, "profile_threads": 0}
    _EMPTY_SPEEDSCOPE = {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": "skyplane-tpu",
        "exporter": "skyplane-tpu-profiler",
        "shared": {"frames": []},
        "profiles": [],
    }

    def ensure_started(self) -> bool:
        return False

    def stop(self) -> None:
        return None

    def sample_once(self) -> int:
        return 0

    def counters(self) -> dict:
        return self._EMPTY_COUNTERS

    def summary(self) -> dict:
        return self._EMPTY_SUMMARY

    def cpu_breakdown(self) -> dict:
        # schema-complete (same keys as StackProfiler.cpu_breakdown) so a
        # disabled-profiler bench run degrades to a zeroed breakdown the
        # gate can report on, never a KeyError mid-bench
        return {
            "stage_cpu_s": {},
            "gil_wait_fraction": 0.0,
            "gil_wait_expected": 0.0,
            "cores_effective": 0.0,
            "runnable_threads": 0.0,
            "cpu_clock": "off",
            "profile_hz": 0.0,
            "profile_samples": 0,
            "profile_samples_dropped": 0,
            "wall_s": 0.0,
        }

    def folded(self) -> List[str]:
        return []

    def speedscope(self) -> dict:
        return self._EMPTY_SPEEDSCOPE

    def reset(self) -> None:
        return None


def merge_profile_summaries(parent: dict, workers) -> dict:
    """Fold pump-worker profiler summaries into the parent daemon's summary
    so one gateway scrape reflects the WHOLE gateway (docs/observability.md;
    `skyplane-tpu flame`/`monitor` and the collector's core-budget block all
    consume this shape). CPU seconds, sample counts and cores-effective ADD
    across processes; the GIL-wait fraction is CPU-weighted (each process
    has its own GIL); per-thread rollups are namespaced by worker."""
    workers = [w for w in (workers or []) if isinstance(w, dict) and w.get("samples")]
    if not workers:
        return parent
    out = dict(parent)
    parts = [parent] + workers
    out["enabled"] = any(bool(p.get("enabled")) for p in parts)
    for key in ("samples", "samples_dropped", "retired_threads", "stacks_truncated"):
        out[key] = sum(int(p.get(key) or 0) for p in parts)
    out["cpu_s"] = round(sum(float(p.get("cpu_s") or 0.0) for p in parts), 4)
    out["cores_effective"] = round(sum(float(p.get("cores_effective") or 0.0) for p in parts), 3)
    out["runnable_threads"] = round(sum(float(p.get("runnable_threads") or 0.0) for p in parts), 2)
    out["wall_s"] = round(max(float(p.get("wall_s") or 0.0) for p in parts), 3)
    weights = [max(1e-9, float(p.get("cpu_s") or 0.0)) for p in parts]
    for key in ("gil_wait_fraction", "gil_wait_expected"):
        total = sum(w * float(p.get(key) or 0.0) for w, p in zip(weights, parts))
        out[key] = round(total / sum(weights), 4)
    stage_cpu: dict = {}
    stage_samples: dict = {}
    for p in parts:
        for s, v in (p.get("stage_cpu_s") or {}).items():
            stage_cpu[s] = round(stage_cpu.get(s, 0.0) + float(v or 0.0), 4)
        for s, v in (p.get("stage_samples") or {}).items():
            stage_samples[s] = round(stage_samples.get(s, 0.0) + float(v or 0.0), 1)
    out["stage_cpu_s"] = stage_cpu
    out["stage_samples"] = stage_samples
    threads = list(parent.get("threads") or [])
    for w in workers:
        tag = w.get("worker") or f"pid{w.get('pid')}"
        for t in w.get("threads") or []:
            threads.append({**t, "name": f"[{tag}] {t.get('name')}"})
    out["threads"] = sorted(threads, key=lambda t: -(t.get("samples") or 0))[:24]
    out["pump_workers"] = len(workers)
    return out


NOOP_PROFILER = _NoopProfiler()

# ---- process-wide singleton (the tracer/injector idiom) ----

_profiler = None
_profiler_lock = threading.Lock()


def _from_env():
    raw = os.environ.get(PROFILE_HZ_ENV, "0").strip()
    try:
        hz = float(raw or 0)
    except ValueError:
        from skyplane_tpu_torch.utils.logger import logger

        logger.fs.warning(f"ignoring malformed {PROFILE_HZ_ENV}={raw!r}; profiling stays off")
        hz = 0.0
    if hz <= 0:
        return NOOP_PROFILER
    try:
        max_stacks = int(os.environ.get(PROFILE_STACKS_ENV, str(DEFAULT_MAX_STACKS)))
    except ValueError:
        max_stacks = DEFAULT_MAX_STACKS
    return StackProfiler(hz=hz, max_stacks=max_stacks)


def get_profiler():
    global _profiler
    p = _profiler
    if p is None:
        with _profiler_lock:
            if _profiler is None:
                _profiler = _from_env()
            p = _profiler
    return p


def configure_profiler(hz: Optional[float] = None, max_stacks: Optional[int] = None):
    """Replace the process profiler (tests, bench passes, daemon overrides);
    ``hz=None`` re-reads the environment. Stops any running sampler first so
    two sampler threads never coexist."""
    global _profiler
    with _profiler_lock:
        old, _profiler = _profiler, None
    if old is not None:
        old.stop()
    with _profiler_lock:
        if hz is None:
            _profiler = _from_env()
        elif hz <= 0:
            _profiler = NOOP_PROFILER
        else:
            _profiler = StackProfiler(hz=hz, max_stacks=max_stacks if max_stacks is not None else DEFAULT_MAX_STACKS)
        return _profiler
