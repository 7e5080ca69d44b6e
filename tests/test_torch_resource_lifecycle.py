"""Twins of ``tests/unit/test_resource_lifecycle.py`` for the port's
analysis (``skyplane_tpu_torch.analysis``): fixture coverage for the
resource-lifecycle dataflow rules (`resource-leak-on-path`,
`double-release`, `escape-without-transfer`,
`uncounted-retry-burns-budget`), the analysis cache, and the behavioural
regression tests of the findings fixed alongside the pass, run on the
port's modules.

Every fixture goes through both packages' analysis
(``tests/torch_analysis_util.py``), which must give equal findings; the
port's are asserted. The firing fixtures are distilled from real shapes —
the requeue GC race and the window double-dispatch — and each has a clean
twin so the rules stay honest about ownership transfer (release-in-finally,
send_fds hand-off, sink-measured re-completion must NOT flag). The cache
twins give each package its own cache file.
"""

from __future__ import annotations

import os
import socket
import threading
import types
import uuid

import pytest

from skyplane_tpu_torch.analysis.cache import AnalysisCache, content_digest
from tests.torch_analysis_util import run_paths, run_source

RES_RULES = {
    "resource-leak-on-path",
    "double-release",
    "escape-without-transfer",
    "uncounted-retry-burns-budget",
}


def res_rules(src: str, path: str = "fixture.py"):
    """Unsuppressed resource-lifecycle rules only — fixtures may incidentally
    poke the concurrency checkers and those are not under test here."""
    return sorted({f.rule for f in run_source(src, path) if not f.suppressed and f.rule in RES_RULES})


# ----------------------------------------------------- resource-leak-on-path


def test_fd_leak_on_early_return_fires():
    assert res_rules(
        """
import os
def probe(path, fast):
    fd = os.open(path, 0)
    if fast:
        return None
    os.close(fd)
    return None
"""
    ) == ["resource-leak-on-path"]


def test_buffer_leak_on_exception_path_fires():
    # risky(buf) can raise before the release runs; the pool slot is gone
    assert res_rules(
        """
def decode(pool, n, risky):
    buf = pool.acquire(n)
    risky(buf)
    pool.release(buf)
"""
    ) == ["resource-leak-on-path"]


def test_release_in_finally_is_clean():
    assert res_rules(
        """
def decode(pool, n, risky):
    buf = pool.acquire(n)
    try:
        risky(buf)
    finally:
        pool.release(buf)
"""
    ) == []


def test_release_in_exhaustive_handler_is_clean():
    # `except BaseException: release; raise` covers the exception path fully —
    # the dispatch node must not leak an unmatched-exception edge outward
    assert res_rules(
        """
def decode(pool, n, risky):
    buf = pool.acquire(n)
    try:
        risky(buf)
    except BaseException:
        pool.release(buf)
        raise
    pool.release(buf)
"""
    ) == []


def test_sched_tokens_leaked_after_conditional_acquire_fires():
    assert res_rules(
        """
def pump(self, req):
    if not self.sched_acquire(req):
        return False
    self._write(req)
    return True
"""
    ) == ["resource-leak-on-path"]


def test_sched_conditional_acquire_with_release_is_clean():
    # the obligation exists only down the granted edge: the early-return
    # path must not flag, and the granted path releases
    assert res_rules(
        """
def pump(self, req):
    if not self.sched_acquire(req):
        return False
    try:
        self._write(req)
    finally:
        self.sched_release(req)
    return True
"""
    ) == []


def test_is_none_guard_polarity_is_clean():
    # `arr` is only ever non-None when the acquire ran; the None edge
    # reaching the bare return must not carry the obligation
    assert res_rules(
        """
def maybe(pool, n):
    arr = None
    if pool is not None:
        arr = pool.acquire(n)
    if arr is not None:
        pool.release(arr)
        return True
    return False
"""
    ) == []


def test_requeue_without_terminal_done_gc_fires():
    # the requeue GC race: a chunk staged into the redrive set with no
    # terminal_done reap anywhere in the function
    assert res_rules(
        """
class Store:
    def requeue(self, chunk_id):
        with self._lock:
            self._redriving.add(chunk_id)
            self._queue.put_nowait(chunk_id)
"""
    ) == ["resource-leak-on-path"]


def test_requeue_with_terminal_done_reap_is_clean():
    assert res_rules(
        """
class Store:
    def requeue(self, chunk_id):
        with self._lock:
            self._terminal_done.pop(chunk_id, None)
            self._redriving.add(chunk_id)
            self._queue.put_nowait(chunk_id)
"""
    ) == []


# ------------------------------------------------------------ double-release


def test_double_sched_release_fires():
    assert res_rules(
        """
def finish(self, req):
    if not self.sched_acquire(req):
        return
    self.sched_release(req)
    self.sched_release(req)
"""
    ) == ["double-release"]


def test_requeue_and_resolve_locally_fires():
    # the window double-dispatch: the chunk is handed to the queue (next
    # consumer owns its terminal state) AND marked complete locally
    assert res_rules(
        """
def on_worker_death(store, q, req, wid):
    store.log_chunk_state(req, ChunkState.in_progress, None, wid)
    q.put_for_handle("h", req)
    store.log_chunk_state(req, ChunkState.complete, None, wid)
"""
    ) == ["double-release"]


def test_sink_measured_recompletion_is_clean():
    # exactly one terminal transition per path — branch-exclusive
    # complete/failed is the normal worker shape, not a double release
    assert res_rules(
        """
def worker(store, req, wid, ok):
    store.log_chunk_state(req, ChunkState.in_progress, None, wid)
    if ok:
        store.log_chunk_state(req, ChunkState.complete, None, wid)
    else:
        store.log_chunk_state(req, ChunkState.failed, None, wid)
"""
    ) == []


def test_close_after_send_fds_is_clean():
    # send_fds dups the descriptor into the message: the sender closing its
    # own copy afterwards is correct, not a double release
    assert res_rules(
        """
import os, socket
def hand_off(chan, path):
    fd = os.open(path, 0)
    try:
        socket.send_fds(chan, [b"x"], [fd])
    finally:
        os.close(fd)
"""
    ) == []


# -------------------------------------------------- escape-without-transfer


def test_open_fd_through_queue_put_fires():
    assert res_rules(
        """
import os
def stage(q, path):
    fd = os.open(path, 0)
    q.put(fd)
"""
    ) == ["escape-without-transfer"]


def test_registered_transfer_then_boundary_is_clean():
    # once ctrl.send(...) moved ownership, later boundary calls on other
    # values must not re-flag the escaped descriptor
    assert res_rules(
        """
import os
def stage(ctrl, q, path):
    fd = os.open(path, 0)
    ctrl.send(fd)
    q.put("done")
"""
    ) == []


# ------------------------------------------- uncounted-retry-burns-budget


def test_uncounted_retry_bump_fires():
    assert res_rules(
        """
def requeue(self, frame):
    frame.counted_retry = False
    frame.retries += 1
    self.q.put_nowait(frame)
"""
    ) == ["uncounted-retry-burns-budget"]


def test_guarded_retry_bump_is_clean():
    assert res_rules(
        """
def requeue(self, frame):
    frame.counted_retry = False
    if frame.counted_retry:
        frame.retries += 1
    self.q.put_nowait(frame)
"""
    ) == []


def test_counted_retry_bump_is_clean():
    assert res_rules(
        """
def requeue(self, frame):
    frame.counted_retry = True
    frame.retries += 1
    self.q.put_nowait(frame)
"""
    ) == []


# ------------------------------------------------------------- suppression


def test_leak_finding_is_suppressible_with_reason():
    findings = run_source(
        """
import os
def park(path):
    # sklint: disable=resource-leak-on-path -- held for process lifetime by design
    fd = os.open(path, 0)
    return None
""",
        "fixture.py",
    )
    leaks = [f for f in findings if f.rule == "resource-leak-on-path"]
    assert leaks and all(f.suppressed for f in leaks)


# ------------------------------------------------------------------- cache


def _write_tree(root, findingless=True):
    good = "def ok():\n    return 1\n"
    bad = "import os\ndef leak(p, c):\n    fd = os.open(p, 0)\n    if c:\n        return\n    os.close(fd)\n"
    (root / "a.py").write_text(good)
    (root / "b.py").write_text(good if findingless else bad)


def test_cache_full_hit_reuses_run_entry(tmp_path):
    _write_tree(tmp_path)
    cpath = tmp_path / "cache.json"
    first = run_paths([str(tmp_path)], use_cache=True, cache_path=cpath)
    assert first.cache_info["full_hit"] is False
    second = run_paths([str(tmp_path)], use_cache=True, cache_path=cpath)
    assert second.cache_info["full_hit"] is True
    assert [f.as_dict() for f in second.findings] == [f.as_dict() for f in first.findings]
    assert second.files_checked == first.files_checked


def test_cache_invalidates_on_edit(tmp_path):
    _write_tree(tmp_path)
    cpath = tmp_path / "cache.json"
    run_paths([str(tmp_path)], use_cache=True, cache_path=cpath)
    _write_tree(tmp_path, findingless=False)  # b.py now leaks
    report = run_paths([str(tmp_path)], use_cache=True, cache_path=cpath)
    assert report.cache_info["full_hit"] is False
    assert report.cache_info["files_reused"] == 1  # a.py unchanged
    assert report.cache_info["files_recomputed"] == 1
    assert "resource-leak-on-path" in {f.rule for f in report.findings}


def test_cache_content_digest_is_stable():
    assert content_digest("x = 1\n") == content_digest("x = 1\n")
    assert content_digest("x = 1\n") != content_digest("x = 2\n")


def test_cache_survives_unwritable_path(tmp_path):
    # a read-only checkout must lint fine, just uncached
    cache = AnalysisCache(tmp_path / "no" / "such" / "dir" / "c.json")
    cache.put_module("m.py", "d", [])
    ro = tmp_path / "no"
    ro.mkdir()
    ro.chmod(0o500)
    try:
        cache.save()  # must not raise
    finally:
        ro.chmod(0o700)


# ----------- regression tests for the findings fixed alongside the pass, on the port


def test_open_0600_closes_fd_when_fchmod_raises(tmp_path, monkeypatch):
    """config.open_0600 leaked the descriptor when fchmod raised (flagged by
    resource-leak-on-path); it must close before re-raising."""
    from skyplane_tpu_torch import config

    closed = []
    real_close = os.close

    def failing_fchmod(fd, mode):
        raise OSError("EPERM")

    def tracking_close(fd):
        closed.append(fd)
        real_close(fd)

    monkeypatch.setattr(os, "fchmod", failing_fchmod)
    monkeypatch.setattr(os, "close", tracking_close)
    with pytest.raises(OSError):
        config.open_0600(tmp_path / "secrets")
    assert len(closed) == 1


def test_sched_acquire_returns_chunk_slot_when_wire_acquire_raises():
    """GatewayOperator.sched_acquire leaked the chunk slot when the wire-byte
    acquire raised (e.g. SchedulerTimeout): nothing downstream knows a slot
    was taken, so the tenant starves its own later chunks."""
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest
    from skyplane_tpu_torch.gateway.operators.gateway_operator import GatewaySenderOperator
    from skyplane_tpu_torch.tenancy import RES_CHUNK_SLOTS, RES_WIRE_BYTES

    calls = []

    class FakeScheduler:
        def acquire(self, tenant, resource, amount, abort_check=None):
            calls.append(("acquire", resource, amount))
            if resource == RES_WIRE_BYTES:
                raise TimeoutError("wire tokens timed out")
            return True

        def release(self, tenant, resource, amount):
            calls.append(("release", resource, amount))

    fake = types.SimpleNamespace(
        scheduler=FakeScheduler(),
        exit_flag=threading.Event(),
        error_event=threading.Event(),
    )
    req = ChunkRequest(
        chunk=Chunk(src_key="s", dest_key="d", chunk_id=uuid.uuid4().hex, chunk_length_bytes=64, partition_id="default")
    )
    with pytest.raises(TimeoutError):
        GatewaySenderOperator.sched_acquire(fake, req)
    assert ("release", RES_CHUNK_SLOTS, 1) in calls


def test_spawn_locked_closes_both_socket_halves_when_process_raises(monkeypatch):
    """MultiProcessPump._spawn_locked leaked both socketpair halves when the
    worker Process failed to construct/start; both must be closed on the
    error path (and only the child half on success)."""
    from skyplane_tpu_torch.gateway import pump as pump_mod

    class ExplodingProcess:
        def __init__(self, *a, **k):
            raise RuntimeError("spawn denied")

    monkeypatch.setattr(pump_mod.SPAWN_CTX, "Process", ExplodingProcess, raising=False)

    made = []
    real_socketpair = socket.socketpair

    def tracking_socketpair(*a, **k):
        pair = real_socketpair(*a, **k)
        made.append(pair)
        return pair

    monkeypatch.setattr(socket, "socketpair", tracking_socketpair)

    pool = pump_mod.PumpPool.__new__(pump_mod.PumpPool)
    pool.cfg = {}
    pool.role = "tx"
    pool.gateway_id = "gw-test"
    with pytest.raises(RuntimeError):
        pool._spawn_locked(0, gen=0)
    assert made, "spawn path should have created a socketpair"
    for a, b in made:
        assert a.fileno() == -1, "parent half left open on spawn failure"
        assert b.fileno() == -1, "child half left open on spawn failure"
