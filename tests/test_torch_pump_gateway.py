"""The port's multi-process pump on daemon pairs, against the JAX package's.

Twins of ``tests/integration/test_pump.py`` on port daemons on the CPU with
``SKYPLANE_TPU_PUMP_PROCS=2``: fd-passed receiver connections, sender windows
framed in worker processes, the control-channel accounting stream, the
telemetry mux, the worker-kill truth table across a real process boundary,
and output equal to the in-process plane's. Mixed fleets: a JAX source into a
port pump destination, and a port pump source whose workers' codec batches
run on its parent's batch runner into a JAX destination. Six daemon pairs in
all.
"""

from __future__ import annotations

import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest

from skyplane_tpu_torch.gateway.pump import is_pump_sender
from tests.torch_gateway_util import (  # noqa: F401
    dispatch, jax_native_build_dir, make_pair, program, read_local_op, receive_op, send_op, start_gateway, stop_all,
    wait_complete,
)


@pytest.fixture
def pump_env(monkeypatch):
    monkeypatch.setenv("SKYPLANE_TPU_PUMP_PROCS", "2")
    monkeypatch.setenv("SKYPLANE_TPU_PERSIST_DEDUP", "0")


@pytest.fixture
def traced_pump_env(pump_env, monkeypatch):
    # the environment arms the workers: spawn children re-read it
    monkeypatch.setenv("SKYPLANE_TPU_TRACE_SAMPLE", "1.0")
    from skyplane_tpu_torch.obs import configure_tracer

    configure_tracer()
    yield
    monkeypatch.delenv("SKYPLANE_TPU_TRACE_SAMPLE")
    configure_tracer()


def _corpus(tmp_path: Path, mb: int, seed: int = 7) -> Path:
    src_file = tmp_path / "src.bin"
    src_file.write_bytes(np.random.default_rng(seed).integers(0, 256, mb << 20, dtype=np.uint8).tobytes())
    return src_file


def _dispatch_file(src, src_file: Path, dst_file: Path, chunk_bytes: int = 256 << 10):
    dst_file.parent.mkdir(parents=True, exist_ok=True)
    return dispatch(src, [(src_file, dst_file, src_file.stat().st_size)], chunk_bytes=chunk_bytes)


def _wait_bytes(dst_file: Path, want: bytes, timeout: float = 10.0) -> bytes:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if dst_file.exists() and dst_file.read_bytes() == want:
            break
        time.sleep(0.2)
    return dst_file.read_bytes() if dst_file.exists() else b""


def _duplicate_sink_registrations(dst) -> int:
    regs = dst.get("chunk_requests", timeout=30).json()["chunk_requests"]
    ids = [r["chunk"]["chunk_id"] for r in regs]
    return len(ids) - len(set(ids))


def _pump_sender(gw):
    ops = [op for op in gw.daemon.operators if is_pump_sender(op)]
    assert ops, "pump sender operator missing"
    return ops[0]


def _until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"not within {timeout:.0f} s: {what}")
        time.sleep(0.05)


def test_pump_transfer_byte_identical(tmp_path, traced_pump_env):
    """Two-process pump end to end: byte-identical output, decode done in the
    worker processes (merged counters), sender windows shipped, and the
    parent's telemetry mux reporting worker CPU and spans."""
    src_file = _corpus(tmp_path, 4)
    dst_file = tmp_path / "out" / "dst.bin"
    src, dst = make_pair(tmp_path, compress="none", dedup=False, num_connections=2)
    try:
        assert dst.daemon.receiver.pump is not None  # receive op => shard pool
        assert src.daemon.receiver.pump is None  # pure source: no idle workers
        ids = _dispatch_file(src, src_file, dst_file)
        wait_complete(src, ids, timeout=120)
        wait_complete(dst, ids, timeout=120)
        assert _wait_bytes(dst_file, src_file.read_bytes()) == src_file.read_bytes()
        _until(lambda: dst.daemon.receiver.decode_counters()["decode_chunks"] >= len(ids), 10,
               "the receiver workers' counter pushes")
        pump_src = src.daemon._pump_counters()
        assert pump_src["batches_shipped"] >= 1
        assert pump_src["workers_alive"] == 2 and pump_src["worker_deaths"] == 0
        assert pump_src["batch_rpcs_served"] == 0  # a CPU daemon has no runner: workers chunk on their own
        assert _duplicate_sink_registrations(dst) == 0
        assert "skyplane_pump_workers_alive" in src.get("metrics", timeout=30).text
        cpu = src.get("profile/cpu", timeout=30).json()
        assert any(name.startswith("pump:") for name in cpu["threads"])
        sender_spans = receiver_spans = []
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            src_events = src.get("trace", timeout=30).json().get("traceEvents", [])
            dst_events = dst.get("trace", timeout=30).json().get("traceEvents", [])
            sender_spans = [e for e in src_events if e.get("name") == "wire.send"]
            receiver_spans = [e for e in dst_events if e.get("name") == "decode"]
            if sender_spans and receiver_spans:
                break
            time.sleep(0.3)
        assert sender_spans, "no worker wire.send spans reached the parent trace export"
        assert receiver_spans, "no worker decode spans reached the parent trace export"
        assert all((e.get("args") or {}).get("gateway") == "gw_src" for e in sender_spans)
        assert all((e.get("args") or {}).get("gateway") == "gw_dst" for e in receiver_spans)
        for gw in (src, dst):
            for owner in gw.daemon._pump_pools():
                for w in owner.pool.live_workers():
                    assert w.counters["runtime"] == {
                        "device": "cpu", "cuda_initialized": False, "jax_loaded": False, "jax_package_loaded": False,
                    }
    finally:
        stop_all(src, dst)


def test_pump_worker_kill_truth_table(tmp_path, pump_env):
    """SIGKILL one sender worker and one receiver worker mid-transfer: both
    pools respawn, the dead sender's un-acked chunks requeue uncounted, chunks
    acked before the kill stay complete, no chunk reads failed, the corpus
    lands byte-identical, and the sink holds one registration per chunk id.
    Every wait is bounded; the kill waits until both pools have live workers
    and a window has been shipped."""
    src_file = _corpus(tmp_path, 12, seed=13)
    dst_file = tmp_path / "out" / "dst.bin"
    src, dst = make_pair(tmp_path, compress="none", dedup=False, num_connections=2)
    try:
        ids = _dispatch_file(src, src_file, dst_file)
        sender = _pump_sender(src)
        _until(lambda: sender.pool is not None and sender.pool.live_workers(), 60, "sender pump workers alive")
        _until(lambda: dst.daemon.receiver.pump.pool.live_workers(), 60, "receiver pump workers alive")
        _until(lambda: sender.pump_counters()["batches_shipped"] >= 1, 60, "a window shipped to a sender worker")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status = src.get("chunk_status_log", timeout=30).json()["chunk_status"]
            if sum(1 for cid in ids if status.get(cid) == "complete") >= 4:
                break
            time.sleep(0.05)
        acked_pre_kill = {
            cid for cid, state in src.get("chunk_status_log", timeout=30).json()["chunk_status"].items()
            if state == "complete" and cid in set(ids)
        }
        os.kill(sender.pool.live_workers()[0].proc.pid, signal.SIGKILL)
        os.kill(dst.daemon.receiver.pump.pool.live_workers()[0].proc.pid, signal.SIGKILL)
        wait_complete(src, ids, timeout=240)
        wait_complete(dst, ids, timeout=240)
        assert _wait_bytes(dst_file, src_file.read_bytes()) == src_file.read_bytes()
        final = src.get("chunk_status_log", timeout=30).json()["chunk_status"]
        assert all(final.get(cid) == "complete" for cid in acked_pre_kill)
        assert _duplicate_sink_registrations(dst) == 0
        pump_src, pump_dst = src.daemon._pump_counters(), dst.daemon._pump_counters()
        assert pump_src["worker_deaths"] + pump_dst["worker_deaths"] >= 2
        assert pump_src["worker_respawns"] >= 1 and pump_dst["worker_respawns"] >= 1
        assert not any(state == "failed" for state in final.values())
    finally:
        stop_all(src, dst)


def test_pump_matches_inprocess_output(tmp_path, pump_env, monkeypatch):
    """The same corpus through the pump and through the in-process plane
    (SKYPLANE_TPU_PUMP_PROCS=0) lands byte-identical files."""
    src_file = _corpus(tmp_path, 2, seed=23)
    out_pump = tmp_path / "out_pump" / "dst.bin"
    src, dst = make_pair(tmp_path / "pump", compress="none", dedup=False)
    try:
        ids = _dispatch_file(src, src_file, out_pump)
        wait_complete(src, ids, timeout=120)
        wait_complete(dst, ids, timeout=120)
    finally:
        stop_all(src, dst)
    monkeypatch.setenv("SKYPLANE_TPU_PUMP_PROCS", "0")
    out_plain = tmp_path / "out_plain" / "dst.bin"
    src2, dst2 = make_pair(tmp_path / "plain", compress="none", dedup=False)
    try:
        assert dst2.daemon.receiver.pump is None  # knob at 0 => the in-process plane
        assert not any(is_pump_sender(op) for op in src2.daemon.operators)
        ids2 = _dispatch_file(src2, src_file, out_plain)
        wait_complete(src2, ids2, timeout=120)
        wait_complete(dst2, ids2, timeout=120)
    finally:
        stop_all(src2, dst2)
    assert _wait_bytes(out_pump, src_file.read_bytes()) == src_file.read_bytes() == out_plain.read_bytes()


def _start_dst(pkg: str, tmp_path: Path, procs: str, monkeypatch):
    monkeypatch.setenv("SKYPLANE_TPU_PUMP_PROCS", procs)
    return start_gateway(pkg, program(receive_op(dedup=True)), {}, "gw_dst", tmp_path / "dst_chunks", use_tls=False)


def _start_src(pkg: str, tmp_path: Path, dst, procs: str, monkeypatch, **kw):
    monkeypatch.setenv("SKYPLANE_TPU_PUMP_PROCS", procs)
    info = {"gw_dst": {"public_ip": "127.0.0.1", "control_port": dst.control_port}}
    send = send_op("gw_dst", compress="tpu", dedup=True, num_connections=2, window=4)
    return start_gateway(pkg, program(read_local_op(send)), info, "gw_src", tmp_path / "src_chunks", use_tls=False, **kw)


@pytest.mark.parametrize("fleet", ["jax_source_into_port_pump", "port_pump_source_with_parent_runner_into_jax"])
def test_mixed_fleet_pump_transfer(tmp_path, monkeypatch, fleet):
    """A JAX source (in-process plane) into a port pump destination, and a
    port pump source into a JAX destination (in-process plane), dedup and
    codec ``tpu`` on: the files land byte-identical. In the second, the port
    source daemon holds a CPU batch runner, so its workers' codec batches are
    RPCs served by that runner: every served RPC is a row of it, none fell
    back to the host and none failed."""
    monkeypatch.setenv("SKYPLANE_TPU_PERSIST_DEDUP", "0")
    src_file = _corpus(tmp_path, 2, seed=41)
    dst_file = tmp_path / "out" / "dst.bin"
    runner = None
    if fleet == "jax_source_into_port_pump":
        dst = _start_dst("port", tmp_path, "2", monkeypatch)
        src = _start_src("ref", tmp_path, dst, "0", monkeypatch)
    else:
        from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
        from skyplane_tpu_torch.ops.cdc import CDCParams

        runner = DeviceBatchRunner(cdc_params=CDCParams(), max_batch=4, device="cpu", gateway_id="gw_src")
        dst = _start_dst("ref", tmp_path, "0", monkeypatch)
        src = _start_src("port", tmp_path, dst, "2", monkeypatch, batch_runner=runner)
    try:
        ids = _dispatch_file(src, src_file, dst_file)
        wait_complete(src, ids, timeout=120)
        wait_complete(dst, ids, timeout=120)
        assert _wait_bytes(dst_file, src_file.read_bytes()) == src_file.read_bytes()
        assert _duplicate_sink_registrations(dst) == 0
        port = dst if fleet == "jax_source_into_port_pump" else src
        pump_counters = port.daemon._pump_counters()
        assert pump_counters["workers_alive"] == 2 and pump_counters["worker_deaths"] == 0
        if runner is None:
            assert pump_counters["conns_dispatched"] >= 1
            _until(lambda: port.daemon.receiver.decode_counters()["decode_chunks"] >= len(ids), 10,
                   "the receiver workers' counter pushes")
        else:
            sender = _pump_sender(src)
            _until(lambda: sender.datapath_counters().get("batch_rpcs_sent", 0) >= pump_counters["batch_rpcs_served"],
                   10, "the workers' final counter pushes")
            served = sender.pump_counters()["batch_rpcs_served"]
            assert served >= len(ids) and sender.pump_counters()["batch_rpc_errors"] == 0
            assert runner.counters()["batch_rows"] >= served
            stats = sender.datapath_counters()
            assert stats["batch_rpc_fallbacks"] == 0 and stats["batch_rpcs_sent"] == served
    finally:
        stop_all(src, dst)
