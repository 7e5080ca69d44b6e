"""Twins of ``tests/unit/test_static_analysis.py`` for the port's analysis
(``skyplane_tpu_torch.analysis``): fixture coverage for every rule (one
firing and one non-firing case each), the suppression contract, the CLI, and
the port's tier-1 gate — the full pass over skyplane_tpu_torch/ must report
zero unsuppressed findings, with every suppression carrying a one-line
justification and none stale.

Every fixture goes through both packages' analysis
(``tests/torch_analysis_util.py``), which must give equal findings; the
port's are asserted. The CLI twins run both packages' ``main`` and compare
exit codes and JSON reports. The last section covers what the port
retargets: ``torch.jit.trace``, ``torch.cuda.make_graphed_callables`` and
``with torch.cuda.graph(...)`` as trace-once forms (``torch.compile`` stays
quiet), and the int64 recast of ``u32-cast-missing``.
"""

from __future__ import annotations

from pathlib import Path

import pytest

import skyplane_tpu_torch.analysis as port_analysis
from skyplane_tpu_torch.analysis.core import iter_rules
from tests.torch_analysis_util import audit_suppressions, lint_main, run_both, run_paths, run_source

REPO_ROOT = Path(__file__).resolve().parents[1]


def rules_of(src: str, path: str = "fixture.py"):
    return sorted({f.rule for f in run_source(src, path) if not f.suppressed})


# ---------------------------------------------------------------- repo gate


@pytest.fixture(scope="module")
def repo_report():
    # one pass over the full port, shared by the gate tests; use_cache
    # exercises the port's content-hash cache (.sklint-cache-torch.json, not
    # the JAX gate's file; keys bake in file digests + the analysis sources,
    # so a hit cannot go stale)
    return port_analysis.run_paths([str(REPO_ROOT / "skyplane_tpu_torch")], use_cache=True)


def test_repo_has_zero_unsuppressed_findings(repo_report):
    """The tier-1 gate: the full pass over the package exits clean. A new
    finding here means a fresh concurrency/tracer hazard — fix it or add a
    `# sklint: disable=<rule> -- <why>` with a real justification."""
    assert repo_report.files_checked > 100  # the walk actually covered the package
    rendered = "\n".join(f.render() for f in repo_report.unsuppressed)
    assert repo_report.ok(), f"unsuppressed lint findings:\n{rendered}"


def test_repo_pass_stays_fast(repo_report):
    """``lint`` and chip_smoke.py run the full pass, so it has to stay
    interactive: even a cold (cache-miss) run must clear 30s with head-room;
    a warm run is a sub-second full hit."""
    assert repo_report.wall_time_s < 30.0, f"whole-repo lint took {repo_report.wall_time_s:.1f}s"


def test_report_rule_counts_are_stable(repo_report):
    """The --json schema contract: every registered rule appears in
    rule_counts even at zero, so dashboards diffing two reports never see
    keys appear/disappear as findings come and go."""
    d = repo_report.as_dict()
    assert set(d["rule_counts"]) == {r.name for r in iter_rules()}
    for counts in d["rule_counts"].values():
        assert set(counts) == {"total", "unsuppressed"}
        assert counts["unsuppressed"] <= counts["total"]
    assert isinstance(d["wall_time_s"], float) and d["wall_time_s"] >= 0.0
    assert set(d["cache"]) >= {"full_hit", "files_reused", "files_recomputed"}


def test_repo_suppressions_all_carry_reasons(repo_report):
    """Reasonless disables surface as findings, so the gate above already
    enforces this — but assert it directly so the contract is explicit."""
    assert not [f for f in repo_report.findings if f.rule == "suppression-missing-reason"]
    for f in repo_report.findings:
        if f.suppressed:
            assert f.suppression_reason.strip(), f"{f.location()} suppressed without a reason"


# ------------------------------------------------------- concurrency rules


RACY_CLASS = """
import threading
class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self.high_water = 0
    def start(self):
        threading.Thread(target=self.loop, daemon=True).start()
    def loop(self):
        while True:
            self.high_water = self.high_water + 1
    def reset(self):
        self.high_water = 0
"""

GUARDED_CLASS = """
import threading
class Pump:
    def __init__(self):
        self._lock = threading.Lock()
        self.high_water = 0
    def start(self):
        threading.Thread(target=self.loop, daemon=True).start()
    def loop(self):
        while True:
            with self._lock:
                self.high_water = self.high_water + 1
    def reset(self):
        with self._lock:
            self.high_water = 0
"""


def test_unlocked_shared_write_fires_on_racy_class():
    assert "unlocked-shared-write" in rules_of(RACY_CLASS)


def test_unlocked_shared_write_quiet_when_every_write_locked():
    assert "unlocked-shared-write" not in rules_of(GUARDED_CLASS)


def test_unlocked_shared_write_ignores_init_writes():
    # __init__ runs before start(): happens-before, not a race
    src = """
import threading
class C:
    def __init__(self):
        self.state = "new"
        threading.Thread(target=self.loop, daemon=True).start()
    def loop(self):
        self.state = "running"
"""
    assert "unlocked-shared-write" not in rules_of(src)


def test_thread_no_daemon_fires_without_daemon_or_join():
    src = """
import threading
def go():
    threading.Thread(target=print).start()
"""
    assert "thread-no-daemon" in rules_of(src)


def test_thread_no_daemon_quiet_with_daemon_or_join():
    src = """
import threading
def go():
    threading.Thread(target=print, daemon=True).start()
def go_joined():
    t = threading.Thread(target=print)
    t.start()
    t.join(timeout=5)
"""
    assert "thread-no-daemon" not in rules_of(src)


def test_blocking_under_lock_fires_on_sleep_and_unbounded_queue_get():
    src = """
import threading, time
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self, work_queue):
        with self._lock:
            time.sleep(1)
    def b(self, work_queue):
        with self._lock:
            item = work_queue.get()
"""
    findings = [f for f in run_source(src) if f.rule == "blocking-under-lock"]
    assert len(findings) == 2


def test_blocking_under_lock_quiet_outside_lock_and_with_timeout():
    src = """
import threading, time
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self, work_queue):
        with self._lock:
            n = 1
        time.sleep(1)
        item = work_queue.get(timeout=0.25)
"""
    assert "blocking-under-lock" not in rules_of(src)


def test_socket_io_under_lock_fires_with_lock_and_acquire_span():
    """The rule the pipelined sender rewrite gates on: socket recv/sendall
    while a lock is held — via a `with` body OR an acquire()/release() span,
    on ANY receiver object (no sock/conn naming requirement)."""
    src = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self, peer):
        with self._lock:
            peer.sendall(b"x")
    def b(self, peer):
        self._lock.acquire()
        try:
            data = peer.recv(1)
        finally:
            self._lock.release()
"""
    findings = [f for f in run_source(src) if f.rule == "socket-io-under-lock"]
    assert len(findings) == 2


def test_socket_io_under_lock_quiet_outside_held_span():
    src = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def a(self, peer):
        with self._lock:
            n = self.depth + 1
        peer.sendall(b"x")
    def b(self, peer):
        self._lock.acquire()
        self._lock.release()
        data = peer.recv(1)
"""
    assert "socket-io-under-lock" not in rules_of(src)


def test_unbounded_queue_in_gateway_fires_on_unbounded_constructions():
    """The tenant-isolation bug class multitenancy must not
    reintroduce: unbounded buffering in gateway code (docs/multitenancy.md)."""
    src = """
import queue
from collections import deque
class C:
    def __init__(self):
        self.q = queue.Queue()
        self.q2 = queue.Queue(maxsize=0)
        self.d = deque()
        self.s = queue.SimpleQueue()
"""
    findings = [
        f
        for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py")
        if f.rule == "unbounded-queue-in-gateway"
    ]
    assert len(findings) == 4


def test_unbounded_queue_in_gateway_quiet_when_bounded_or_outside_gateway():
    bounded = """
import queue
from collections import deque
class C:
    def __init__(self, n):
        self.q = queue.Queue(maxsize=4096)
        self.q2 = queue.Queue(n)
        self.d = deque(maxlen=8)
        self.d2 = deque([], 16)
"""
    assert "unbounded-queue-in-gateway" not in rules_of(bounded, "skyplane_tpu_torch/gateway/fixture.py")
    # the same unbounded constructions OUTSIDE a gateway path are not flagged
    unbounded = """
import queue
q = queue.Queue()
"""
    assert "unbounded-queue-in-gateway" not in rules_of(unbounded, "skyplane_tpu_torch/api/fixture.py")


def test_unbounded_queue_in_gateway_suppressible():
    src = """
import queue
class C:
    def __init__(self):
        # sklint: disable=unbounded-queue-in-gateway -- drained unconditionally by the main loop
        self.q = queue.Queue()
"""
    findings = [
        f
        for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py")
        if f.rule == "unbounded-queue-in-gateway"
    ]
    assert findings and all(f.suppressed for f in findings)


def test_bare_except_in_loop_fires():
    src = """
def serve(q):
    while True:
        try:
            q.get_nowait()
        except:
            pass
"""
    assert "bare-except-in-loop" in rules_of(src)


def test_bare_except_in_loop_quiet_when_typed_or_reraised():
    src = """
def serve(q):
    while True:
        try:
            q.get_nowait()
        except ValueError:
            pass
        try:
            q.get_nowait()
        except BaseException:
            raise
"""
    assert "bare-except-in-loop" not in rules_of(src)


def test_flat_sleep_in_retry_loop_fires_in_except_and_attempt_loop():
    """The recovery-contract bug class the fault-injection work removed: flat
    reconnect sleeps (no jitter, no deadline) in gateway/api retry paths."""
    src = """
import time

def reconnect(sock):
    try:
        sock.connect()
    except OSError:
        time.sleep(0.2)

def dispatch(post):
    for attempt in range(4):
        try:
            return post()
        except Exception:
            time.sleep(0.5 * (attempt + 1))
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "flat-sleep-in-retry-loop"
    ]
    assert len(findings) == 2


def test_flat_sleep_in_retry_loop_quiet_on_policy_names_and_other_paths():
    src = """
import time

def reconnect(sock, policy, n):
    try:
        sock.connect()
    except OSError:
        time.sleep(policy.backoff_s(n))  # jittered policy call: clean

def poll(poll_interval):
    while True:
        try:
            tick()
        except OSError:
            pass
        time.sleep(poll_interval)  # adaptive name, not flat

def pump():
    while True:  # poll loop whose inner drain loop owns the except
        while True:
            try:
                drain()
            except Empty:
                break
        time.sleep(0.05)
"""
    assert not [f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "flat-sleep-in-retry-loop"]
    # identical flat sleep outside gateway//api trees: out of scope
    flat = """
import time

def f():
    try:
        go()
    except OSError:
        time.sleep(0.2)
"""
    assert not [f for f in run_source(flat, "skyplane_tpu_torch/ops/fixture.py") if f.rule == "flat-sleep-in-retry-loop"]


def test_flat_sleep_in_retry_loop_suppressible():
    src = """
import time

def f():
    try:
        go()
    except OSError:
        time.sleep(0.2)  # sklint: disable=flat-sleep-in-retry-loop -- fixture: bounded one-shot wait documented here
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/api/fixture.py") if f.rule == "flat-sleep-in-retry-loop"
    ]
    assert findings and all(f.suppressed for f in findings)


def test_unbounded_wait_in_provisioner_fires_on_deadlineless_poll_loop():
    """The bug class behind the r05 rc=124 artifact loss: a provisioning
    wait that can spin forever (docs/provisioning.md)."""
    src = """
import time

def wait_running(check):
    while True:
        if check():
            break
        time.sleep(5)
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/compute/fixture.py") if f.rule == "unbounded-wait-in-provisioner"
    ]
    assert len(findings) == 1
    assert "deadline" in findings[0].message


def test_unbounded_wait_in_provisioner_quiet_when_bounded_or_elsewhere():
    deadline_in_test = """
import time

def wait_op(url):
    deadline = time.time() + 300
    while time.time() < deadline:
        if done(url):
            return
        time.sleep(2)
    raise TimeoutError(url)
"""
    deadline_in_body = """
import time

def wait_state(get):
    deadline = time.time() + 600
    while True:
        if get() == "RUNNING":
            break
        if time.time() >= deadline:
            raise TimeoutError("not RUNNING after 600s")
        time.sleep(10)
"""
    bounded_for = """
import time

def probe(fn):
    for _ in range(20):
        if fn():
            return True
        time.sleep(0.5)
    return False
"""
    pagination = """
def drain(api):
    req = api.first()
    while req is not None:
        req = api.next(req)
"""
    for fixture in (deadline_in_test, deadline_in_body, bounded_for, pagination):
        assert not [
            f for f in run_source(fixture, "skyplane_tpu_torch/compute/fixture.py") if f.rule == "unbounded-wait-in-provisioner"
        ], fixture
    # the same deadlineless loop OUTSIDE compute/ is not this rule's business
    src = deadline_in_test.replace("deadline = time.time() + 300\n    while time.time() < deadline:", "while True:")
    assert not [
        f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unbounded-wait-in-provisioner"
    ]


def test_unbounded_wait_in_provisioner_suppressible():
    src = """
import time

def wait_forever(check):
    # sklint: disable=unbounded-wait-in-provisioner -- fixture: caller holds the watchdog
    while not check():
        time.sleep(1)
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/compute/fixture.py") if f.rule == "unbounded-wait-in-provisioner"
    ]
    assert findings and all(f.suppressed for f in findings)


def test_unjoined_thread_in_gateway_fires_on_unmanaged_thread():
    """The drain/repair bug class: a long-lived control thread
    under gateway//compute/ with neither daemon= nor a joined stop path
    outlives shutdown."""
    bound_never_joined = """
import threading

class Watcher:
    def start(self):
        self._t = threading.Thread(target=self.loop)
        self._t.start()
    def loop(self): ...
"""
    unbound_fire_and_forget = """
import threading

def kick(fn):
    threading.Thread(target=fn).start()
"""
    for fixture in (bound_never_joined, unbound_fire_and_forget):
        findings = [
            f for f in run_source(fixture, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unjoined-thread-in-gateway"
        ]
        assert len(findings) == 1, fixture
    # compute/ paths are covered too (repair threads live there)
    findings = [
        f
        for f in run_source(unbound_fire_and_forget, "skyplane_tpu_torch/compute/fixture.py")
        if f.rule == "unjoined-thread-in-gateway"
    ]
    assert len(findings) == 1


def test_unjoined_thread_in_gateway_quiet_when_daemon_joined_or_elsewhere():
    daemonized = """
import threading

def kick(fn):
    threading.Thread(target=fn, daemon=True).start()
"""
    joined_in_stop = """
import threading

class Drainer:
    def start(self):
        self._t = threading.Thread(target=self.loop)
        self._t.start()
    def loop(self): ...
    def stop(self):
        self._t.join(timeout=2.0)
"""
    joined_loop_var = """
import threading

class Pool:
    def start(self):
        self.workers = []
        for i in range(4):
            t = threading.Thread(target=self.loop)
            t.start()
            self.workers.append(t)
    def loop(self): ...
    def stop(self):
        for t in self.workers:
            t.join()
"""
    for fixture in (daemonized, joined_in_stop, joined_loop_var):
        assert not [
            f for f in run_source(fixture, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unjoined-thread-in-gateway"
        ], fixture
    # outside gateway//compute/ this rule stays quiet (thread-no-daemon owns it)
    unmanaged = """
import threading

def kick(fn):
    threading.Thread(target=fn).start()
"""
    assert not [
        f for f in run_source(unmanaged, "skyplane_tpu_torch/obs/fixture.py") if f.rule == "unjoined-thread-in-gateway"
    ]


def test_unjoined_thread_in_gateway_suppressible():
    src = """
import threading

def kick(fn):
    # sklint: disable=unjoined-thread-in-gateway -- fixture: process-lifetime thread documented here
    threading.Thread(target=fn).start()
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unjoined-thread-in-gateway"
    ]
    assert findings and all(f.suppressed for f in findings)


def test_unbounded_event_log_fires_on_untrimmed_event_append():
    """The flight-recorder bug class (docs/observability.md): an event record
    appended forever in gateway code is unbounded memory charged to every
    tenant on the box."""
    src = """
class Recorder:
    def __init__(self):
        self.events = []
        self.firing_log = []

    def loop(self, q):
        while True:
            self.events.append(q.get())
            self.firing_log.append({"fired": True})
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unbounded-event-log"
    ]
    assert len(findings) == 2, findings
    assert all(not f.suppressed for f in findings)
    # same source under obs/ also fires; under api/ it is out of scope
    assert "unbounded-event-log" in rules_of(src, "skyplane_tpu_torch/obs/fixture.py")
    assert "unbounded-event-log" not in rules_of(src, "skyplane_tpu_torch/api/fixture.py")


def test_unbounded_event_log_quiet_when_bounded_trimmed_or_local():
    src = """
from collections import deque

class Recorder:
    CAP = 100

    def __init__(self):
        self.events = deque(maxlen=4096)          # structural bound
        self.status_journal = []                  # trimmed below, drop counted
        self.journal_dropped = 0

    def record(self, ev):
        self.events.append(ev)
        self.status_journal.append(ev)
        if len(self.status_journal) > self.CAP:
            overflow = len(self.status_journal) - self.CAP
            del self.status_journal[:overflow]
            self.journal_dropped += overflow

def export(ring):
    events = []                                   # local: dies with the call
    for slot in ring:
        events.append(slot)
    return events
"""
    assert "unbounded-event-log" not in rules_of(src, "skyplane_tpu_torch/gateway/fixture.py")


def test_unbounded_event_log_suppressible_with_reason():
    src = """
class Window:
    def __init__(self):
        self.frame_events = []

    def note(self, ev):
        # sklint: disable=unbounded-event-log -- fixture: one entry per in-flight frame, capped by the byte window
        self.frame_events.append(ev)
"""
    findings = [
        f for f in run_source(src, "skyplane_tpu_torch/gateway/fixture.py") if f.rule == "unbounded-event-log"
    ]
    assert findings and all(f.suppressed for f in findings)


# ------------------------------------------------------------- span rules


def test_blocking_io_in_span_fires_in_span_exit_and_record_callback():
    """The overhead-regression bug class the obs tracer must never grow:
    syscalls on the span-record path (skyplane_tpu_torch/obs/tracer.py contract)."""
    src = """
import os, time
class FancySpan:
    def __exit__(self, *exc):
        with open("/tmp/spans.log", "a") as f:
            f.write(self.name)
class RingBuffer:
    def record(self, entry):
        self.sock.sendall(entry)
def on_span_end(span, sink):
    time.sleep(0.01)
"""
    findings = [f for f in run_source(src) if f.rule == "blocking-io-in-span"]
    assert len(findings) == 3
    assert all(f.severity == "error" for f in findings)


def test_blocking_io_in_span_fires_while_holding_ring_slot():
    src = """
def publish(ring, payload, peer):
    with ring.slot() as rec:
        peer.sendall(payload)
        rec.value = payload
"""
    findings = [f for f in run_source(src) if f.rule == "blocking-io-in-span"]
    assert len(findings) == 1


def test_blocking_io_in_span_quiet_on_pure_record_and_instrumented_io():
    """Pure tuple-store records are clean, and instrumenting I/O from the
    OUTSIDE (`with tracer.span(...)` around a send) is the intended use."""
    src = """
import time
class Span:
    def __exit__(self, *exc):
        self._ring.buf[self._i] = (self.name, time.perf_counter_ns())
class Tracer:
    def span(self, name):
        return Span()
def pump(tracer, sock, frame):
    with tracer.span("wire.send"):
        sock.sendall(frame)
def helper_outside_scope(path):
    return open(path).read()
"""
    assert "blocking-io-in-span" not in rules_of(src)


def test_blocking_io_in_span_suppressible():
    src = """
class DebugSpan:
    def __exit__(self, *exc):
        print_to = open("/tmp/x", "a")  # sklint: disable=blocking-io-in-span -- debug-only span sink, not shipped
"""
    assert all(f.suppressed for f in run_source(src) if f.rule == "blocking-io-in-span")


# ------------------------------------------------- frame-walk safety rule


def test_frame_walk_under_lock_fires_when_snapshot_taken_under_lock():
    """The sampler-deadlock bug class (obs/profiler.py): snapshotting
    sys._current_frames() while holding a lock — a walked thread blocked on
    that same lock wedges the process the profiler observes. Import aliases
    must not dodge the match."""
    src = """
import sys, threading
class Sampler:
    def snap(self):
        with self._lock:
            return dict(sys._current_frames())
"""
    assert "frame-walk-under-lock" in rules_of(src)
    aliased = """
from sys import _current_frames as cf
class Sampler:
    def snap(self):
        with self._lock:
            return cf()
"""
    assert "frame-walk-under-lock" in rules_of(aliased)


def test_frame_walk_under_lock_fires_on_lock_and_callback_inside_walk():
    """Inside the walk loop: taking a lock per walked thread, or invoking a
    non-local callback (caller-supplied parameter / on_* attribute), runs
    blocking or arbitrary code inside the most delicate loop in the process."""
    lock_in_walk = """
import sys
class Sampler:
    def walk(self):
        for tid, frame in sys._current_frames().items():
            with self._lock:
                self.table[tid] = frame
"""
    assert "frame-walk-under-lock" in rules_of(lock_in_walk)
    cb_param = """
import sys
def walk(callback):
    for tid, frame in sys._current_frames().items():
        callback(tid, frame)
"""
    assert "frame-walk-under-lock" in rules_of(cb_param)
    cb_attr = """
import threading
class Sampler:
    def walk(self):
        for t in threading.enumerate():
            self.on_sample(t)
"""
    assert "frame-walk-under-lock" in rules_of(cb_attr)


def test_frame_walk_under_lock_quiet_on_snapshot_then_merge():
    """The safe pattern the profiler uses: snapshot first, fold into LOCAL
    aggregates with pure operations, merge under the lock AFTER the walk.
    Reading thread attributes in the walk (thread_cpu_seconds) is clean too."""
    src = """
import sys, threading
class Sampler:
    def sample_once(self):
        frames = sys._current_frames()
        rows = []
        for tid, frame in frames.items():
            rows.append((tid, frame.f_code.co_name))
        names = {}
        for t in threading.enumerate():
            names[t.ident] = t.name
        with self._lock:
            self._merge(rows, names)
"""
    assert "frame-walk-under-lock" not in rules_of(src)


def test_frame_walk_under_lock_suppressible():
    src = """
import sys
class Sampler:
    def snap(self):
        with self._lock:
            return dict(sys._current_frames())  # sklint: disable=frame-walk-under-lock -- shutdown-only path, all threads parked
"""
    assert all(f.suppressed for f in run_source(src) if f.rule == "frame-walk-under-lock")


# ------------------------------------------------------------ tracer rules


def test_jit_impure_call_fires_on_time_and_np_random():
    src = """
import jax, time
import numpy as np
from functools import partial
@partial(jax.jit, static_argnames=("n",))
def f(x, n):
    seed = time.time()
    noise = np.random.rand(n)
    return x + seed + noise
"""
    findings = [f for f in run_source(src) if f.rule == "jit-impure-call"]
    assert len(findings) == 2


def test_jit_impure_call_quiet_on_jax_random_and_host_fn():
    src = """
import jax, time
import jax.numpy as jnp
@jax.jit
def f(x, key):
    return x + jax.random.normal(key, x.shape)
def host(x):
    return time.time()  # not traced: no jit anywhere near it
"""
    assert "jit-impure-call" not in rules_of(src)


def test_jit_impure_call_resolves_import_aliases():
    # `import time as t` / `from time import time` must not dodge the match
    src = """
import jax
import time as t
from time import sleep as pause
@jax.jit
def f(x):
    pause(0.1)
    return x * t.time()
"""
    findings = [f for f in run_source(src) if f.rule == "jit-impure-call"]
    assert len(findings) == 2


def test_jit_impure_call_fires_on_fn_passed_to_jax_jit():
    src = """
import jax, time
def f(x):
    return x + time.time()
g = jax.jit(f)
"""
    assert "jit-impure-call" in rules_of(src)


def test_jit_attr_mutation_fires_on_self_assignment():
    src = """
import jax
class K:
    @jax.jit
    def f(self, x):
        self.last_x = x
        self.history.append(x)
        return x
"""
    findings = [f for f in run_source(src) if f.rule == "jit-attr-mutation"]
    assert len(findings) == 2


def test_jit_attr_mutation_quiet_on_locals():
    src = """
import jax
@jax.jit
def f(x):
    y = x + 1
    acc = []
    acc.append(y)  # local list: consumed within the trace, not host state
    return y
"""
    assert "jit-attr-mutation" not in rules_of(src)


def test_jit_host_sync_fires_on_float_and_item():
    src = """
import jax
@jax.jit
def f(x):
    lo = float(x)
    hi = x.max().item()
    return lo + hi
"""
    findings = [f for f in run_source(src) if f.rule == "jit-host-sync"]
    assert len(findings) == 2


def test_jit_host_sync_quiet_on_static_args():
    src = """
import jax
from functools import partial
@partial(jax.jit, static_argnames=("block_bytes",))
def f(x, block_bytes):
    n = int(block_bytes)  # static: a real Python int at trace time
    return x * n
"""
    assert "jit-host-sync" not in rules_of(src)


def test_u32_cast_missing_fires_in_ops_contract_function():
    src = """
import jax.numpy as jnp
M31 = (1 << 31) - 1
def gear_step(state, byte):
    return (state * byte) % M31
"""
    assert "u32-cast-missing" in rules_of(src, "skyplane_tpu_torch/ops/gear.py")


def test_u32_cast_missing_quiet_when_cast_or_outside_ops():
    cast_src = """
import jax.numpy as jnp
M31 = (1 << 31) - 1
def gear_step(state, byte):
    state = state.astype(jnp.uint32)
    byte = jnp.uint32(byte)
    return (state * byte) % M31
"""
    assert "u32-cast-missing" not in rules_of(cast_src, "skyplane_tpu_torch/ops/gear.py")
    # same racy arithmetic outside ops/: the contract does not apply
    bad_src = """
M31 = (1 << 31) - 1
def gear_step(state, byte):
    return (state * byte) % M31
"""
    assert "u32-cast-missing" not in rules_of(bad_src, "skyplane_tpu_torch/planner/whatever.py")


# ----------------------------------------------------- durability rules


def test_unsynced_durable_write_fires_on_bare_snapshot_replace():
    """The torn-state bug class the service must never ship: an
    os.replace landing a snapshot/journal with no fsync of the staged file
    and parent directory in the enclosing function."""
    src = """
import os
def compact(self):
    tmp = self.snap_path.with_name("jobs.snap.tmp")
    tmp.write_bytes(b"x")
    os.replace(tmp, self.snap_path)
"""
    assert "unsynced-durable-write" in rules_of(src)


def test_unsynced_durable_write_fires_on_rename_with_one_fsync():
    """One fsync (the file) is not enough — the parent directory must also
    be synced or the rename itself can be forgotten."""
    src = """
import os
def land(self):
    tmp = self.dir / "state.tmp"
    with open(tmp, "wb") as f:
        f.write(b"x")
        os.fsync(f.fileno())
    os.rename(tmp, self.dir / "journal.state")
"""
    assert "unsynced-durable-write" in rules_of(src)


def test_unsynced_durable_write_quiet_on_fsync_replace_helper():
    src = """
from skyplane_tpu_torch.utils.fsio import fsync_replace
def compact(self):
    tmp = self.snap_path.with_name("jobs.snap.tmp")
    tmp.write_bytes(b"x")
    fsync_replace(tmp, self.snap_path)
"""
    assert "unsynced-durable-write" not in rules_of(src)


def test_unsynced_durable_write_quiet_on_inline_fsync_pair():
    src = """
import os
def compact(self):
    tmp = self.journal_path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(b"x")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, self.journal_path)
    fd = os.open(str(self.journal_path.parent), os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
"""
    assert "unsynced-durable-write" not in rules_of(src)


def test_unsynced_durable_write_quiet_on_non_durable_paths():
    """Scratch/log/output renames are not durable state — loss is
    inconvenience, not incorrectness — and must not need suppressions."""
    src = """
import os
def rotate(self):
    os.replace(self.out_path, self.backup_path)
"""
    assert "unsynced-durable-write" not in rules_of(src)


def test_unsynced_durable_write_suppressible():
    src = """
import os
def compact(self):
    os.replace(self.tmp, self.snap_path)  # sklint: disable=unsynced-durable-write -- snapshot is a rebuildable cache
"""
    assert "unsynced-durable-write" not in rules_of(src)


# ---------------------------------------------------- suppression contract


def test_suppression_with_reason_suppresses():
    src = """
import threading
def go():
    threading.Thread(target=print).start()  # sklint: disable=thread-no-daemon -- harness thread, process exits with it
"""
    findings = run_source(src)
    sup = [f for f in findings if f.rule == "thread-no-daemon"]
    assert sup and all(f.suppressed for f in sup)
    assert sup[0].suppression_reason.startswith("harness thread")
    assert not [f for f in findings if not f.suppressed]


def test_standalone_suppression_covers_next_line():
    src = """
import threading
def go():
    # sklint: disable=thread-no-daemon -- covered: comment applies to the next code line
    threading.Thread(target=print).start()
"""
    assert all(f.suppressed for f in run_source(src) if f.rule == "thread-no-daemon")


def test_suppression_without_reason_is_a_finding_and_suppresses_nothing():
    src = """
import threading
def go():
    threading.Thread(target=print).start()  # sklint: disable=thread-no-daemon
"""
    rules = rules_of(src)
    assert "suppression-missing-reason" in rules
    assert "thread-no-daemon" in rules  # the bare disable un-gated nothing


def test_suppression_unknown_rule_warns():
    src = "x = 1  # sklint: disable=no-such-rule -- typo'd rule name\n"
    assert "suppression-unknown-rule" in rules_of(src)


def test_parse_error_is_a_finding():
    assert rules_of("def broken(:\n") == ["parse-error"]


def test_clean_file_has_no_findings():
    src = """
import threading
import jax.numpy as jnp

def double(x):
    return jnp.asarray(x) * 2

class Safe:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
    def add(self, n):
        with self._lock:
            self.total += n
"""
    assert rules_of(src) == []


def test_every_rule_is_registered_exactly_once():
    names = [r.name for r in iter_rules()]
    assert len(names) == len(set(names))
    # the two checker families the issue requires: >= 8 repo rules
    assert len([n for n in names if not n.startswith(("parse-", "suppression-"))]) >= 8


# ------------------------------------------------------------- CLI surface


def test_cli_json_report(tmp_path, capsys):
    import json

    bad = tmp_path / "bad.py"
    bad.write_text("import threading\nthreading.Thread(target=print).start()\n")
    out = tmp_path / "report.json"
    rc = lint_main([str(bad), "--json", str(out)])
    assert rc == 1
    report = json.loads(out.read_text())
    assert report["ok"] is False and report["files_checked"] == 1
    assert [f["rule"] for f in report["findings"]] == ["thread-no-daemon"]
    assert f"{bad}:2" in capsys.readouterr().out


def test_cli_clean_exit_zero(tmp_path):
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(good)]) == 0


def test_cli_missing_path_is_usage_error_not_clean(tmp_path, capsys):
    """A typo'd path or wrong cwd must exit 2 loudly — 'checked 0 files'
    with exit 0 would make the devloop/CI gate vacuously green."""
    assert lint_main([str(tmp_path / "no_such_dir")]) == 2
    assert lint_main([str(tmp_path / "no_such_file.py")]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_rule_filter_applies_to_framework_findings_too(tmp_path):
    """A --rule scoped run must not fail on findings the caller excluded,
    parse errors included (run_paths and run_source agree on this)."""
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:\n")
    scoped = run_paths([str(bad)], rules={"thread-no-daemon"})
    assert scoped.ok() and not scoped.findings
    unscoped = run_paths([str(bad)])
    assert [f.rule for f in unscoped.findings] == ["parse-error"]


# --------------------------------------------------- stale-suppression audit


def test_stale_suppression_reported_under_check_suppressions(tmp_path):
    """A disable whose rule no longer fires on its line rots the
    justification discipline — the --check-suppressions pass names it."""
    src = tmp_path / "stale.py"
    src.write_text(
        "def fine():\n"
        "    x = 1  # sklint: disable=blocking-under-lock -- historical: the lock was refactored away\n"
        "    return x\n"
    )
    plain = run_paths([str(src)])
    assert plain.ok(), "a dead suppression is silent without the audit flag"
    audited = run_paths([str(src)], check_suppressions=True)
    assert not audited.ok()
    assert [f.rule for f in audited.unsuppressed] == ["stale-suppression"]
    assert "blocking-under-lock" in audited.unsuppressed[0].message


def test_live_suppression_is_not_stale(tmp_path):
    src = tmp_path / "live.py"
    src.write_text(
        "import threading\n"
        "def go():\n"
        "    threading.Thread(target=print).start()  # sklint: disable=thread-no-daemon -- fixture thread dies with the test\n"
    )
    audited = run_paths([str(src)], check_suppressions=True)
    assert audited.ok(), "\n".join(f.render() for f in audited.unsuppressed)


def test_stale_audit_ignores_rule_filter(tmp_path):
    """The audit must judge liveness against the UNFILTERED findings — a
    --rule filter must not make every other rule's suppression look dead."""
    src = tmp_path / "filtered.py"
    src.write_text(
        "import threading\n"
        "def go():\n"
        "    threading.Thread(target=print).start()  # sklint: disable=thread-no-daemon -- fixture thread dies with the test\n"
    )
    audited = run_paths([str(src)], rules={"stale-suppression"}, check_suppressions=True)
    assert audited.ok(), "\n".join(f.render() for f in audited.unsuppressed)


def test_cli_check_suppressions_flag(tmp_path, capsys):
    stale = tmp_path / "stale.py"
    stale.write_text("x = 1  # sklint: disable=bare-except-in-loop -- no loop here anymore\n")
    assert lint_main([str(stale)]) == 0
    assert lint_main([str(stale), "--check-suppressions"]) == 1
    assert "stale-suppression" in capsys.readouterr().out


def test_repo_has_no_stale_suppressions(repo_report):
    """The in-repo discipline gate: every sklint disable in the package still
    suppresses a live finding (satellite: dead suppressions fixed/removed)."""
    from skyplane_tpu_torch.analysis.core import _iter_py_files, known_rule_names, load_module

    modules = []
    known = known_rule_names()
    for fs_path, display in _iter_py_files([str(REPO_ROOT / "skyplane_tpu_torch")]):
        module, _ = load_module(fs_path, display, known=known)
        if module is not None:
            modules.append(module)
    stale = audit_suppressions(modules, repo_report.findings)
    assert not stale, "\n".join(f.render() for f in stale)


def test_unknown_rule_disable_is_not_also_stale(tmp_path):
    """suppression-unknown-rule already covers a disable naming a
    nonexistent rule; the stale audit must not double-report it with
    misleading 'no longer fires' advice."""
    src = tmp_path / "unknown.py"
    src.write_text("x = 1  # sklint: disable=no-such-rule -- typo fixture\n")
    audited = run_paths([str(src)], check_suppressions=True)
    assert [f.rule for f in audited.unsuppressed] == ["suppression-unknown-rule"]


def test_rules_and_severities_equal_the_jax_packages():
    """Every rule stays registered under its JAX name and severity, so
    ``rule_counts`` lists the same keys in both packages."""
    from skyplane_tpu.analysis.core import iter_rules as ref_iter_rules

    assert [(r.name, r.severity) for r in iter_rules()] == [(r.name, r.severity) for r in ref_iter_rules()]


# ------------------------------------------ the port's retargeted forms


TORCH_TRACED = """
import time
import numpy as np
import torch
from torch.jit import trace as tr

def step(x, n: int):
    t0 = time.time()
    print("tracing")
    return x * n + t0

traced = torch.jit.trace(step, (torch.ones(2), 3))

class K:
    def forward(self, x):
        self.last = x
        self.seen.append(x)
        return float(x) + np.random.rand()

def fwd(y):
    return y.sum().item()

t2 = tr(fwd, torch.ones(()))
t3 = torch.jit.trace(K().forward, torch.ones(()))
"""


def _torch_only(port, ref):
    """The JAX package knows no torch form: its findings are the port's
    without the jit-* rules."""
    jit_rules = {"jit-impure-call", "jit-attr-mutation", "jit-host-sync"}
    from tests.torch_analysis_util import assert_same

    assert_same([f for f in port if f.rule not in jit_rules], ref)
    assert not [f for f in ref if f.rule in jit_rules]
    return [f for f in port if f.rule in jit_rules]


def test_torch_jit_trace_fires_the_trace_once_rules():
    port, ref = run_both(TORCH_TRACED)
    got = _torch_only(port, ref)
    by_line = sorted((f.line, f.rule) for f in got)
    assert by_line == [
        (8, "jit-impure-call"),
        (9, "jit-impure-call"),
        (21, "jit-host-sync"),
    ]
    assert all("traced by torch.jit.trace" in f.message for f in got), [f.message for f in got]
    # the JAX texts are kept for jax.jit only
    assert not [f for f in got if "jit function" in f.message]
    # a bound method passed by attribute is not resolved (as jax.jit(self.f) is not)
    assert not [f for f in got if "'forward'" in f.message]


def test_torch_jit_trace_quiet_on_pure_function_and_int_params():
    src = """
import torch
def quiet(x, n: int):
    m = int(n)
    return x * m
q = torch.jit.trace(quiet, (torch.ones(2), 3))
"""
    port, ref = run_both(src)
    assert _torch_only(port, ref) == []


def test_make_graphed_callables_fires_on_host_sync_and_mutation():
    src = """
import torch
class Step:
    def body(self, x):
        self.calls += 1
        return x + x.sum().item()
def plain(x):
    return x * 2
def lookup(x):
    return bool(x)
g = torch.cuda.make_graphed_callables((plain, lookup), ((torch.ones(2),), (torch.ones(2),)))
h = torch.cuda.make_graphed_callables(Step().body, (torch.ones(2),))
"""
    port, ref = run_both(src)
    got = _torch_only(port, ref)
    assert [(f.line, f.rule) for f in got] == [(10, "jit-host-sync")]
    assert "graphed by torch.cuda.make_graphed_callables" in got[0].message
    assert "raises during CUDA graph capture" in got[0].message


def test_cuda_graph_block_fires_inside_the_capture_only():
    src = """
import time
import torch
class Runner:
    def capture(self, x, steps: int):
        g = torch.cuda.CUDAGraph()
        t0 = time.time()  # before capture: runs every time capture() runs
        with torch.cuda.graph(g):
            y = x * 2
            self.last = y
            self.log.append(int(steps))
            total = y.sum().item()
            print(total)
            ok = bool(y)
        self.graph = g  # after capture: host code as usual
        return float(x) + t0
"""
    port, ref = run_both(src)
    got = _torch_only(port, ref)
    assert sorted((f.line, f.rule) for f in got) == [
        (10, "jit-attr-mutation"),
        (11, "jit-attr-mutation"),
        (12, "jit-host-sync"),
        (13, "jit-impure-call"),
        (14, "jit-host-sync"),
    ]
    assert all("the torch.cuda.graph capture block at line 8" in f.message for f in got)


def test_cuda_graph_block_resolves_import_aliases():
    src = """
import torch.cuda as tc
from torch.cuda import graph as capture
def run(x, g, h):
    with capture(g):
        y = x.item()
    with tc.graph(h):
        z = float(x)
"""
    port, ref = run_both(src)
    assert [(f.line, f.rule) for f in _torch_only(port, ref)] == [(6, "jit-host-sync"), (8, "jit-host-sync")]


def test_torch_compile_stays_quiet():
    """Dynamo breaks the graph at print and time.time() and keeps the side
    effects: torch.compile is not a trace-once form."""
    src = """
import time
import torch
@torch.compile
def f(x):
    print("runs every call under dynamo")
    return x * time.time() + x.sum().item()
def g(x):
    return float(x) + time.time()
h = torch.compile(g)
@torch.compile(mode="reduce-overhead")
def k(self, x):
    self.last = x
    return x
"""
    port, ref = run_both(src)
    assert _torch_only(port, ref) == []
    assert port == [] and ref == []


def test_jax_jit_keeps_its_messages():
    src = """
import jax
@jax.jit
def f(x):
    print(x)
    return x.item()
"""
    findings = run_source(src)  # equal to the JAX package's, messages included
    assert {f.message for f in findings} == {
        "print() inside jit function 'f' is baked into the trace as a constant/one-shot",
        ".item() in jit function 'f' concretizes a tracer (crash) or forces a device sync",
    }


U32_INT64 = """
import numpy as np
import torch
M31 = (1 << 31) - 1
def fold31(x):
    return x
def addmod31(a, b):
    a = a.to(torch.int64)
    b = b.to(dtype=torch.long)
    return fold31(a + b)
def mulmod31(a, b):
    a = a.long()
    b = b.astype(np.int64)
    return fold31(a * b)
def shifted(a, k):
    a = a.to(torch.int32)
    return fold31(a << k)
"""


def test_u32_int64_recast_is_the_ports_sanctioned_cast():
    port, ref = run_both(U32_INT64, "skyplane_tpu_torch/ops/u32.py")
    assert [(f.line, f.rule) for f in port] == [(17, "u32-cast-missing"), (17, "u32-cast-missing")]
    assert {f.message for f in port} == {
        "parameter 'a' used in `<<` in 'shifted' without an explicit int64 cast "
        "(a = a.to(torch.int64); ops/u32.py contract: int64 operands reduced by fold31)",
        "parameter 'k' used in `<<` in 'shifted' without an explicit int64 cast "
        "(k = k.to(torch.int64); ops/u32.py contract: int64 operands reduced by fold31)",
    }
    # the JAX package knows only its jnp.uint32 cast: it flags every function
    assert sorted({f.line for f in ref}) == [10, 14, 17]
    assert {f.rule for f in ref} == {"u32-cast-missing"}


def test_u32_jnp_cast_still_sanctioned_in_the_port():
    src = """
import jax.numpy as jnp
M31 = (1 << 31) - 1
def gear_step(state, byte):
    state = state.astype(jnp.uint32)
    byte = jnp.uint32(byte)
    return (state * byte) % M31
"""
    assert run_source(src, "skyplane_tpu_torch/ops/gear.py") == []


def test_ports_u32_module_carries_the_cast():
    """ops/u32.py's addmod31/mulmod31 carry the int64 cast, so the port's
    rule is quiet there; the cast is a no-op on the int64 tensors callers
    pass (no copy)."""
    import torch

    from skyplane_tpu_torch.ops import u32

    path = REPO_ROOT / "skyplane_tpu_torch" / "ops" / "u32.py"
    report = port_analysis.run_paths([str(path)])
    assert report.ok() and report.files_checked == 1
    a = torch.tensor([5, u32.M31 - 1], dtype=torch.int64)
    assert a.to(torch.int64) is a
    assert u32.addmod31(a, a).tolist() == [10, u32.M31 - 2]
    assert u32.mulmod31(a, a).tolist() == [25, 1]
