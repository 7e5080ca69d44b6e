"""The port's multi-process pump (``skyplane_tpu_torch/gateway/pump.py``) against
the JAX package's, unit by unit.

Twins of ``tests/unit/test_pump.py``: the control channel (framing, fd
alignment, raw trailers, corrupt lengths), the worker-side remote batch
runner against both packages' exact host kernels and its counted dead-parent
fallback, the counter and profile merges, the env knobs and the counter
schema, chunk-store gating, the parent's shard accounting (terminal outcomes,
death requeue, a failed ship), and the daemon with the pump gated off and on.
Beside them: the control channel's frames are byte-equal to the JAX
package's and the two channels talk to each other both ways; the worker
configs of the sender pump and the receiver pump carry the JAX package's
keys and values; the JAX package's fork-safety lint rules pass over the port
module; a spawned port worker runs on the CPU with neither jax nor the JAX
package loaded and no CUDA context, whatever ``SKYPLANE_GATEWAY_DEVICE`` says.
"""

from __future__ import annotations

import importlib
import os
import queue
import socket
import threading
import time

import numpy as np
import pytest
import torch

from skyplane_tpu.gateway import pump as ref_pump
from skyplane_tpu_torch.gateway import pump
from skyplane_tpu_torch.gateway.pump import (
    PUMP_COUNTER_ZERO,
    PUMP_PROCS_ENV,
    CtrlChannel,
    _WorkerHandle,
    merge_numeric_counters,
    pump_procs,
)
from tests.torch_gateway_util import jax_native_build_dir, program, read_local_op, receive_op, send_op  # noqa: F401

_MODS = {"port": pump, "ref": ref_pump}


# ---------------------------------------------------------------- channel


def _channel_pair(a_pkg: str = "port", b_pkg: str = "port"):
    a, b = socket.socketpair()
    return _MODS[a_pkg].CtrlChannel(a), _MODS[b_pkg].CtrlChannel(b)


def test_ctrl_channel_roundtrip_and_eof():
    tx, rx = _channel_pair()
    assert tx.send({"type": "x", "n": 1})
    assert tx.send({"type": "y", "payload": "z" * 100_000})  # multi-recv message
    msg, fds = rx.recv()
    assert msg == {"type": "x", "n": 1} and fds == []
    msg, fds = rx.recv()
    assert msg["type"] == "y" and len(msg["payload"]) == 100_000
    tx.close()
    assert rx.recv() is None  # clean EOF
    assert tx.send({"type": "late"}) is False  # closed channel reports, not raises
    rx.close()


def test_ctrl_channel_fd_passing_alignment():
    tx, rx = _channel_pair()
    r1, w1 = socket.socketpair()
    try:
        tx.send({"type": "plain1"})
        tx.send({"type": "conn", "n_fds": 1}, fds=(w1.fileno(),))
        tx.send({"type": "plain2"})
        m1, f1 = rx.recv()
        m2, f2 = rx.recv()
        m3, f3 = rx.recv()
        assert (m1["type"], f1) == ("plain1", [])
        assert m2["type"] == "conn" and len(f2) == 1
        assert (m3["type"], f3) == ("plain2", [])
        passed = socket.socket(fileno=f2[0])  # the passed fd is live
        passed.sendall(b"ping")
        assert r1.recv(4) == b"ping"
        passed.close()
    finally:
        for s in (r1, w1):
            s.close()
        tx.close()
        rx.close()


def test_ctrl_channel_corrupt_length_is_death_not_oom():
    a, b = socket.socketpair()
    rx = CtrlChannel(b)
    a.sendall(b"\xff\xff\xff\xff")  # 4 GiB declared length
    assert rx.recv() is None
    a.close()
    rx.close()


def test_ctrl_channel_raw_trailer_roundtrip():
    tx, rx = _channel_pair()
    r1, w1 = socket.socketpair()
    blob = os.urandom(200_000)  # multi-recv trailer
    try:
        tx.send({"type": "plain1"})
        tx.send({"type": "batch_rpc", "rpc_id": 7}, raw=blob)
        tx.send({"type": "conn", "n_fds": 1}, fds=(w1.fileno(),), raw=b"xy")
        tx.send({"type": "plain2"})
        m1, f1 = rx.recv()
        m2, f2 = rx.recv()
        m3, f3 = rx.recv()
        m4, f4 = rx.recv()
        assert (m1["type"], f1) == ("plain1", []) and "_raw" not in m1
        assert m2["rpc_id"] == 7 and m2["raw_len"] == len(blob) and m2["_raw"] == blob
        assert m3["_raw"] == b"xy" and len(f3) == 1
        assert (m4["type"], f4) == ("plain2", [])
        os.close(f3[0])
    finally:
        for s in (r1, w1):
            s.close()
        tx.close()
        rx.close()


def test_ctrl_channel_oversized_raw_is_death_not_oom():
    import json
    import struct

    a, b = socket.socketpair()
    rx = CtrlChannel(b)
    payload = json.dumps({"type": "batch_rpc", "raw_len": CtrlChannel.MAX_RAW + 1}).encode()
    a.sendall(struct.pack("!I", len(payload)) + payload)
    assert rx.recv() is None  # corrupt stream: treated as peer death
    a.close()
    rx.close()


_FRAMES = [
    ({"type": "counters", "worker": "pump-sender0.g0", "process_cpu_s": 1.25, "events": []}, None),
    ({"type": "batch_rpc", "rpc_id": 3}, bytes(range(256)) * 9),
    ({"type": "batch_result", "rpc_id": 3, "ends": [4096, 9000, 12345]}, b"\x01" * 48),
    ({"type": "status", "chunk_id": "ab" * 16, "state": "complete"}, None),
    ({"type": "stop"}, b""),
]


def _wire_bytes(pkg: str) -> bytes:
    a, b = socket.socketpair()
    chan = _MODS[pkg].CtrlChannel(a)
    for msg, raw in _FRAMES:
        assert chan.send(msg, raw=raw)
    chan.close()
    out = bytearray()
    while True:
        got = b.recv(1 << 16)
        if not got:
            break
        out += got
    b.close()
    return bytes(out)


def test_ctrl_channel_frames_equal_the_reference():
    assert _wire_bytes("port") == _wire_bytes("ref")


@pytest.mark.parametrize("direction", [("port", "ref"), ("ref", "port")], ids=["port_to_jax", "jax_to_port"])
def test_ctrl_channel_interop_with_fds_and_raw(direction):
    """A port channel and a JAX channel on one socketpair: messages, passed
    descriptors and raw trailers cross in both directions."""
    tx, rx = _channel_pair(*direction)
    r1, w1 = socket.socketpair()
    blob = os.urandom(3 << 20)  # larger than the socket buffer: the reader drains while the writer sends
    sent = []

    def writer():
        sent.append(tx.send({"type": "conn", "port": 1234, "n_fds": 1}, fds=(w1.fileno(),)))
        sent.append(tx.send({"type": "batch_rpc", "rpc_id": 11}, raw=blob))
        sent.append(tx.send({"type": "batch", "n_fds": 1, "reqs": []}, fds=(w1.fileno(),), raw=b"tail"))

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        m1, f1 = rx.recv()
        m2, f2 = rx.recv()
        m3, f3 = rx.recv()
        assert m1 == {"type": "conn", "port": 1234, "n_fds": 1} and len(f1) == 1
        assert m2["_raw"] == blob and m2["rpc_id"] == 11 and f2 == []
        assert m3["_raw"] == b"tail" and len(f3) == 1
        t.join(timeout=10)
        assert not t.is_alive() and sent == [True, True, True]
        passed = socket.socket(fileno=f1[0])
        passed.sendall(b"pong")
        assert r1.recv(4) == b"pong"
        passed.close()
        os.close(f3[0])
        # and back the other way on the same pair
        assert rx.send({"type": "batch_result", "rpc_id": 11, "ends": [1, 2]}, raw=b"\x07" * 32)
        back, fds = tx.recv()
        assert back["ends"] == [1, 2] and back["_raw"] == b"\x07" * 32 and fds == []
    finally:
        for s in (r1, w1):
            s.close()
        tx.close()
        rx.close()


# ------------------------------------------------- parent-routed batches


def _params(pkg: str):
    return importlib.import_module(_pkg_root(pkg) + ".ops.cdc").CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)


def _pkg_root(pkg: str) -> str:
    return {"port": "skyplane_tpu_torch", "ref": "skyplane_tpu"}[pkg]


def _host(pkg: str):
    return importlib.import_module(_pkg_root(pkg) + ".ops.cdc").cdc_and_fps_host


@pytest.mark.parametrize("server", ["port", "ref"], ids=["port_host_kernels", "jax_host_kernels"])
def test_remote_batch_runner_matches_host_kernels(server):
    """The worker-side proxy over a real socketpair, served by a parent thread
    with either package's exact host kernels: results equal both packages'
    ``cdc_and_fps_host``, and the runner surface the processor uses is intact."""
    params = _params("port")
    wchan, pchan = _channel_pair()
    runner = pump.RemoteBatchRunner(wchan, params)
    assert runner.remote is True and runner.cdc_params == params
    serve, serve_params = _host(server), _params(server)

    def parent():
        while True:
            got = pchan.recv()
            if got is None:
                return
            msg, _fds = got
            ends, fps = serve(np.frombuffer(msg["_raw"], np.uint8), serve_params)
            pchan.send({"type": "batch_result", "rpc_id": msg["rpc_id"], "ends": np.asarray(ends).tolist()},
                       raw=b"".join(fps))

    def resolver():
        while True:
            got = wchan.recv()
            if got is None:
                return
            msg, _fds = got
            if msg.get("type") == "batch_result":
                runner.resolve(msg)

    threads = [threading.Thread(target=parent, daemon=True), threading.Thread(target=resolver, daemon=True)]
    for t in threads:
        t.start()
    try:
        rng = np.random.default_rng(33)
        chunks = [rng.integers(0, 256, 50_000, dtype=np.uint8) for _ in range(3)]
        chunks.append(np.zeros(20_000, np.uint8))
        results = [runner.cdc_and_fps(c) for c in chunks]
        for chunk, (ends, fps) in zip(chunks, results):
            for pkg in ("port", "ref"):
                want_ends, want_fps = _host(pkg)(chunk, _params(pkg))
                np.testing.assert_array_equal(ends, want_ends)
                assert fps == want_fps
        c = runner.counters()
        assert c["batch_rpcs_sent"] == len(chunks) and c["batch_rpc_fallbacks"] == 0
    finally:
        for chan in (wchan, pchan):
            chan.sock.shutdown(socket.SHUT_RDWR)  # wakes both blocked readers with EOF
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        wchan.close()
        pchan.close()


def test_remote_batch_runner_dead_parent_falls_back_counted():
    """Parent gone: submit() completes through the exact host kernels (equal
    to both packages') and counts it in ``batch_rpc_fallbacks``."""
    wchan, pchan = _channel_pair()
    pchan.close()
    runner = pump.RemoteBatchRunner(wchan, _params("port"))
    chunk = np.random.default_rng(34).integers(0, 256, 30_000, dtype=np.uint8)
    ends, fps = runner.cdc_and_fps(chunk)
    for pkg in ("port", "ref"):
        want_ends, want_fps = _host(pkg)(chunk, _params(pkg))
        np.testing.assert_array_equal(ends, want_ends)
        assert fps == want_fps
    assert runner.counters()["batch_rpc_fallbacks"] == 1
    wchan.close()


def test_remote_batch_runner_error_reply_raises():
    """A parent-side failure reaches the worker as an error, never as data."""
    wchan, _pchan = _channel_pair()
    runner = pump.RemoteBatchRunner(wchan, _params("port"))
    handle = runner.submit(np.zeros(100, np.uint8))
    runner.resolve({"type": "batch_result", "rpc_id": 0, "error": "boom"})
    with pytest.raises(RuntimeError, match="boom"):
        handle.ends()
    wchan.close()


def test_processor_takes_the_remote_branch_on_a_cpu_processor():
    """A CPU processor accepts a remote runner (no device test), checks its CDC
    params, and routes CDC + fingerprints through it before anything else."""
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    params = _params("port")

    class _Stub:
        remote = True
        cdc_params = params

        def __init__(self):
            from skyplane_tpu_torch.ops.bufpool import BufferPool

            self.pool = BufferPool()
            self.calls = 0

        def counters(self):
            return {}

        def submit(self, arr):
            self.calls += 1
            ends, fps = _host("port")(arr, params)
            return type("H", (), {"ends": lambda s: ends, "fps": lambda s: fps, "wait_ns": 0})()

    stub = _Stub()
    proc = DataPathProcessor(codec_name="none", dedup=True, cdc_params=params, batch_runner=stub, device="cpu")
    data = np.random.default_rng(5).integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    out = proc.process(data, SenderDedupIndex())
    assert stub.calls == 1 and out.is_recipe
    ref = DataPathProcessor(codec_name="none", dedup=True, cdc_params=params, device="cpu").process(data, SenderDedupIndex())
    assert out.wire_bytes == ref.wire_bytes and out.fingerprint == ref.fingerprint
    bad = DataPathProcessor(codec_name="none", dedup=True, cdc_params=_params("port").__class__(), batch_runner=stub,
                            device="cpu")
    with pytest.raises(ValueError, match="CDC params"):
        bad.process(data, SenderDedupIndex())


# ----------------------------------------------------------------- merging


def test_merge_numeric_counters_sums_and_recomputes_rate():
    base = {"decode_chunks": 1, "pool_hits": 1, "pool_misses": 1, "pool_hit_rate": 0.5, "label": "x"}
    snaps = [{"decode_chunks": 4, "pool_hits": 7, "pool_misses": 1}]
    merged = merge_numeric_counters(base, snaps)
    assert merged == ref_pump.merge_numeric_counters(base, snaps)
    assert merged["decode_chunks"] == 5 and merged["pool_hit_rate"] == 0.8 and merged["label"] == "x"
    assert merge_numeric_counters({"enabled": True}, [{"enabled": True}])["enabled"] is True


def test_merge_profile_summaries_sums_cores_and_weights_gil():
    from skyplane_tpu.obs.profiler import merge_profile_summaries as ref_merge
    from skyplane_tpu_torch.obs.profiler import merge_profile_summaries

    parent = {
        "enabled": True, "samples": 100, "samples_dropped": 0, "cpu_s": 2.0, "cores_effective": 0.8,
        "runnable_threads": 3.0, "wall_s": 5.0, "gil_wait_fraction": 0.4, "gil_wait_expected": 0.3,
        "stage_cpu_s": {"decode": 1.0, "framing": 0.5}, "stage_samples": {"decode": 50.0},
        "threads": [{"name": "main", "samples": 60, "cpu_s": 1.5, "on_cpu_frac": 0.9}],
        "retired_threads": 0, "stacks_truncated": 0,
    }
    worker = {
        "enabled": True, "worker": "pump-sender0.g0", "samples": 200, "samples_dropped": 1, "cpu_s": 6.0,
        "cores_effective": 0.9, "runnable_threads": 2.0, "wall_s": 4.0, "gil_wait_fraction": 0.1,
        "gil_wait_expected": 0.1, "stage_cpu_s": {"decode": 3.0, "codec": 2.0}, "stage_samples": {"decode": 120.0},
        "threads": [{"name": "receiver-decode-0", "samples": 150, "cpu_s": 4.0, "on_cpu_frac": 1.0}],
        "retired_threads": 1, "stacks_truncated": 0,
    }
    out = merge_profile_summaries(parent, [worker])
    assert out == ref_merge(parent, [worker])
    assert out["samples"] == 300 and out["cores_effective"] == pytest.approx(1.7)
    assert out["gil_wait_fraction"] == pytest.approx(0.175, abs=1e-4) and out["pump_workers"] == 1
    assert "[pump-sender0.g0] receiver-decode-0" in [t["name"] for t in out["threads"]]
    assert merge_profile_summaries(parent, []) is parent
    assert merge_profile_summaries(parent, [{"samples": 0}]) is parent


# --------------------------------------------------------------- env knobs


@pytest.mark.parametrize("value,want", [(None, 0), ("4", 4), ("-2", 0), ("garbage", 0), ("0", 0)])
def test_pump_procs_env_parsing(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv(PUMP_PROCS_ENV, raising=False)
    else:
        monkeypatch.setenv(PUMP_PROCS_ENV, value)
    assert pump_procs() == want == ref_pump.pump_procs()


def test_pump_counter_zero_schema_and_env_names():
    assert PUMP_COUNTER_ZERO == ref_pump.PUMP_COUNTER_ZERO
    assert all(isinstance(v, (int, float)) for v in PUMP_COUNTER_ZERO.values())
    for name in ("PUMP_PROCS_ENV", "PUMP_RESPAWNS_ENV", "PUMP_PUSH_S_ENV", "PUMP_CRASH_POINT"):
        assert getattr(pump, name) == getattr(ref_pump, name)
    assert pump.SPAWN_CTX.get_start_method() == "spawn"


def test_chunk_store_clean_stale_gating(tmp_path):
    from skyplane_tpu_torch.gateway.chunk_store import ChunkStore

    live = tmp_path / "ab.chunk"
    live.write_bytes(b"payload")
    ChunkStore(str(tmp_path), clean_stale=False)  # pump worker: must NOT sweep
    assert live.exists()
    ChunkStore(str(tmp_path))  # daemon default: sweeps leftovers
    assert not live.exists()


def test_child_device_ignores_the_daemon_device_and_never_falls_back(monkeypatch):
    """The worker's device comes from SKYPLANE_TPU_PUMP_CHILD_PLATFORM (cpu by
    default), never from the inherited SKYPLANE_GATEWAY_DEVICE; ``cuda`` on a
    host without a card raises. On the CPU, ``tpu_zstd`` resolves to ``zstd``
    as a CPU-pinned JAX worker's does."""
    from skyplane_tpu.ops.pipeline import effective_codec_name as ref_codec
    from skyplane_tpu_torch.ops.pipeline import effective_codec_name

    monkeypatch.setenv("SKYPLANE_GATEWAY_DEVICE", "cuda")
    monkeypatch.delenv(pump.PUMP_CHILD_PLATFORM_ENV, raising=False)
    dev = pump._child_device()
    assert dev == torch.device("cpu")
    assert effective_codec_name("tpu_zstd", dev) == ref_codec("tpu_zstd") == "zstd"
    monkeypatch.setenv(pump.PUMP_CHILD_PLATFORM_ENV, "")
    assert pump._child_device() == torch.device("cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv(pump.PUMP_CHILD_PLATFORM_ENV, "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            pump._child_device()
    monkeypatch.setenv(pump.PUMP_CHILD_PLATFORM_ENV, "tpu")  # a JAX platform name is no torch device
    with pytest.raises(RuntimeError, match="tpu"):
        pump._child_device()


# -------------------------------------------- shard-accounting truth table


class _DummyProc:
    exitcode = -9

    @staticmethod
    def is_alive():
        return False


class _DummyChan:
    def __init__(self):
        self.sent = []

    def send(self, msg, fds=()):
        self.sent.append(msg)
        return True

    def close(self):
        pass


class _FakePool:
    def __init__(self):
        self.slot_event = threading.Event()

    def live_workers(self):
        return []

    def counters(self):
        return {}


def _pump_op_kwargs(pkg: str, tmp_path, **kw):
    root = _pkg_root(pkg)
    ChunkStore = importlib.import_module(root + ".gateway.chunk_store").ChunkStore
    GatewayQueue = importlib.import_module(root + ".gateway.gateway_queue").GatewayQueue
    out_q = GatewayQueue()
    out_q.register_handle("downstream")
    kwargs = dict(
        handle="send", region="local:local", input_queue=GatewayQueue(), output_queue=out_q,
        error_event=threading.Event(), error_queue=queue.Queue(), chunk_store=ChunkStore(str(tmp_path / pkg)),
        n_workers=2, gateway_id="gw_test", pump_procs=2, target_gateway_id="gw_dst", target_host="127.0.0.1",
        target_control_port=1, use_tls=False, **kw,
    )
    if pkg == "port":
        kwargs["device"] = "cpu"
    return kwargs, out_q


def _make_pump_op(tmp_path):
    """A port pump sender operator with NO pool spawned: the parent-side
    accounting in isolation."""
    kwargs, out_q = _pump_op_kwargs("port", tmp_path)
    op = pump.make_sender_pump_operator(**kwargs)
    op.pool = _FakePool()
    return op, out_q


def _req(i: int):
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest

    return ChunkRequest(chunk=Chunk(src_key="s", dest_key="d", chunk_id=f"{i:032x}", chunk_length_bytes=64, file_offset_bytes=0))


def test_terminal_outcome_accounting(tmp_path):
    """complete -> logged complete and forwarded downstream; failed -> logged
    failed; a second terminal for the same chunk id is a no-op."""
    op, out_q = _make_pump_op(tmp_path)
    assert pump.is_pump_sender(op)
    w = _WorkerHandle(0, 0, "w0", _DummyProc(), _DummyChan())
    r_ok, r_bad = _req(1), _req(2)
    with op._acct_lock:
        op._outstanding[r_ok.chunk.chunk_id] = r_ok
        op._outstanding[r_bad.chunk.chunk_id] = r_bad
        w.outstanding.update({r_ok.chunk.chunk_id, r_bad.chunk.chunk_id})
    op._on_terminal(w, {"chunk_id": r_ok.chunk.chunk_id, "state": "complete"})
    op._on_terminal(w, {"chunk_id": r_bad.chunk.chunk_id, "state": "failed"})
    op._on_terminal(w, {"chunk_id": r_ok.chunk.chunk_id, "state": "complete"})
    assert out_q.pop("downstream", timeout=1).chunk.chunk_id == r_ok.chunk.chunk_id
    with pytest.raises(queue.Empty):
        out_q.get_nowait("downstream")
    states = {}
    while True:
        try:
            rec = op.chunk_store.chunk_status_queue.get_nowait()
        except queue.Empty:
            break
        states[rec["chunk_id"]] = rec["state"]
    assert states[r_ok.chunk.chunk_id] == "complete" and states[r_bad.chunk.chunk_id] == "failed"
    assert not op._outstanding


def test_worker_death_requeues_uncounted(tmp_path):
    """Acked chunks stay complete and are not requeued; everything else
    outstanding on the dead worker returns to the input queue with its retry
    budget untouched."""
    op, _ = _make_pump_op(tmp_path)
    w = _WorkerHandle(0, 0, "w0", _DummyProc(), _DummyChan())
    acked, pending1, pending2 = _req(3), _req(4), _req(5)
    for r in (acked, pending1, pending2):
        with op._acct_lock:
            op._outstanding[r.chunk.chunk_id] = r
            w.outstanding.add(r.chunk.chunk_id)
    op._on_terminal(w, {"chunk_id": acked.chunk.chunk_id, "state": "complete"})
    op._on_worker_death(w)
    requeued = set()
    while True:
        try:
            requeued.add(op.input_queue.get_nowait(op.handle).chunk.chunk_id)
        except queue.Empty:
            break
    assert requeued == {pending1.chunk.chunk_id, pending2.chunk.chunk_id}
    assert not hasattr(pending1, "wire_retries") and not getattr(pending1.chunk, "wire_retries", None)
    assert op.pump_counters()["chunks_requeued_on_death"] == 2
    op._on_terminal(w, {"chunk_id": pending1.chunk.chunk_id, "state": "complete"})
    assert not op._outstanding


def test_failed_ship_requeues_once_without_redispatch(tmp_path):
    op, _ = _make_pump_op(tmp_path)

    class _DeadChan(_DummyChan):
        def send(self, msg, fds=()):
            return False  # worker died between selection and send

    w = _WorkerHandle(0, 0, "w0", _DummyProc(), _DeadChan())
    healthy = _WorkerHandle(1, 0, "w1", _DummyProc(), _DummyChan())
    picks = [w, healthy]

    class _Pool(_FakePool):
        def least_loaded(self, cap):
            return picks.pop(0) if picks else None

    op.pool = _Pool()
    r = _req(9)
    assert op._ship([r]) is True
    assert op.input_queue.get_nowait(op.handle).chunk.chunk_id == r.chunk.chunk_id
    with pytest.raises(queue.Empty):
        op.input_queue.get_nowait(op.handle)
    assert healthy.chan.sent == []
    assert not op._outstanding and not healthy.outstanding


def test_batch_rpc_served_on_the_parent_runner_and_dead_worker_tolerated(tmp_path):
    """``_serve_batch_rpc`` runs a worker's chunk through the parent's runner
    (here a CPU DeviceBatchRunner) and replies with the exact host result; a
    reply to a worker that died meanwhile is dropped and the parent goes on."""
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

    params = _params("port")
    runner = DeviceBatchRunner(cdc_params=params, max_batch=2, device="cpu")
    kwargs, _ = _pump_op_kwargs("port", tmp_path, batch_runner=runner, cdc_params=params, dedup=True)
    op = pump.make_sender_pump_operator(**kwargs)
    op.pool = _FakePool()
    assert op._pool_cfg()["parent_batch"] is True

    class _DeadChan(_DummyChan):
        def send(self, msg, fds=(), raw=None):
            return False

    class _RawChan(_DummyChan):
        def send(self, msg, fds=(), raw=None):
            self.sent.append((msg, raw))
            return True

    live = _WorkerHandle(0, 0, "w0", _DummyProc(), _RawChan())
    dead = _WorkerHandle(1, 0, "w1", _DummyProc(), _DeadChan())
    chunk = np.random.default_rng(8).integers(0, 256, 70_000, dtype=np.uint8)
    try:
        op._serve_batch_rpc(dead, {"type": "batch_rpc", "rpc_id": 0, "_raw": chunk.tobytes()})
        op._serve_batch_rpc(live, {"type": "batch_rpc", "rpc_id": 1, "_raw": chunk.tobytes()})
        deadline = time.monotonic() + 30
        while not live.chan.sent and time.monotonic() < deadline:
            time.sleep(0.01)
        msg, raw = live.chan.sent[0]
        ends, fps = _host("port")(chunk, params)
        assert msg == {"type": "batch_result", "rpc_id": 1, "ends": np.asarray(ends).tolist()}
        assert raw == b"".join(fps)
        c = op.pump_counters()
        assert c["batch_rpcs_served"] == 2 and c["batch_rpc_errors"] == 0
        assert runner.counters()["batch_rows"] == 2
    finally:
        op._batch_rpc_pool.shutdown(wait=True)


# ------------------------------------------------------------ worker configs


def test_sender_pool_cfg_equals_the_reference(tmp_path):
    cfgs = {}
    for pkg in ("port", "ref"):
        kwargs, _ = _pump_op_kwargs(pkg, tmp_path, codec_name="tpu_zstd", dedup=True, window=8)
        op = _MODS[pkg].make_sender_pump_operator(**kwargs)
        cfg = op._pool_cfg()
        cfg["chunk_dir"] = os.path.basename(cfg["chunk_dir"])
        cfgs[pkg] = cfg
    assert cfgs["port"] == {**cfgs["ref"], "chunk_dir": "port"}


def test_receiver_enable_pump_cfg_equals_the_reference(tmp_path, monkeypatch):
    """``GatewayReceiver.enable_pump`` hands its pump the JAX package's worker
    config for the same receiver, and retires the parent decode pool."""
    cfgs = {}
    for pkg in ("port", "ref"):
        root = _pkg_root(pkg)
        seen = {}

        class _Recorder:
            def __init__(self, cfg, procs, **kw):
                seen.update(cfg=cfg, procs=procs, kw=kw)

            def stop(self):
                pass

            def decode_snapshots(self):
                return []

        monkeypatch.setattr(_MODS[pkg], "ReceiverPump", _Recorder)
        rx_mod = importlib.import_module(root + ".gateway.operators.gateway_receiver")
        store = importlib.import_module(root + ".gateway.chunk_store").ChunkStore(str(tmp_path / pkg))
        seg = importlib.import_module(root + ".ops.dedup").SegmentStore()
        kw = {"device": "cpu"} if pkg == "port" else {}
        rx = rx_mod.GatewayReceiver(
            region="local:local", chunk_store=store, error_event=threading.Event(), error_queue=queue.Queue(),
            use_tls=False, e2ee_key=bytes(range(32)), dedup=True, segment_store=seg, gateway_id="gw", **kw,
        )
        rx.enable_pump(2, persist_dedup=True)
        assert rx._decode_threads == [] and seen["procs"] == 2
        assert set(seen["kw"]) == {"gateway_id", "error_event", "error_queue", "tenant_registry"}
        rx.stop_all()
        cfg = dict(seen["cfg"])
        cfg["chunk_dir"] = os.path.basename(cfg["chunk_dir"])
        cfgs[pkg] = cfg
    assert cfgs["port"] == {**cfgs["ref"], "chunk_dir": "port"}


# --------------------------------------------------------- lint rules


def test_pump_module_clean_under_fork_and_ipc_rules():
    """The JAX package's fork-safety rules pass over the port's pump.py: spawn,
    never fork; no lock, socket or tracer over a multiprocessing channel; no
    lock held across a fork."""
    from skyplane_tpu.analysis.core import load_module, run_module

    module, errors = load_module(pump.__file__, display_path="skyplane_tpu_torch/gateway/pump.py")
    assert module is not None and not errors
    findings = [f for f in run_module(module) if not f.suppressed]
    bad = [f for f in findings if f.rule in ("fork-with-threads", "unsafe-object-over-ipc", "lock-held-across-fork")]
    assert bad == [], [f.render() for f in bad]


# ----------------------------------------------------------- the daemon


def _daemon(tmp_path, prog, info=None):
    from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon

    return GatewayDaemon(
        region="local:local", chunk_dir=str(tmp_path / "chunks"), gateway_program=prog,
        gateway_info=info or {"gw_b": {"public_ip": "127.0.0.1", "control_port": 18081}}, gateway_id="gw_a",
        control_port=0, bind_host="127.0.0.1", use_tls=False, device="cpu",
    )


def test_receiver_pump_gated_off_by_default(tmp_path, monkeypatch):
    """SKYPLANE_TPU_PUMP_PROCS unset: structurally the in-process daemon, no
    pump on the receiver, the plain sender class, zeroed pump counters."""
    monkeypatch.delenv(PUMP_PROCS_ENV, raising=False)
    monkeypatch.setenv("SKYPLANE_TPU_PERSIST_DEDUP", "0")
    daemon = _daemon(tmp_path, program(read_local_op(send_op("gw_b"))))
    try:
        assert daemon.pump_procs == 0 and daemon.receiver.pump is None
        assert not any(pump.is_pump_sender(op) for op in daemon.operators)
        assert type(daemon.operators[-1]).__name__ == "GatewaySenderOperator"
        assert daemon._pump_counters() == dict(PUMP_COUNTER_ZERO)
    finally:
        daemon.api.stop()
        daemon.receiver.stop_all()


def test_pump_on_daemon_builds_pump_receiver_and_senders(tmp_path, monkeypatch):
    """SKYPLANE_TPU_PUMP_PROCS=2 on a relay program (receive, then send): the
    receiver gets a pump of two spawned workers, the send op is a pump sender
    with no shared dedup index, and the pump counters count both pools."""
    monkeypatch.setenv(PUMP_PROCS_ENV, "2")
    monkeypatch.setenv("SKYPLANE_TPU_PERSIST_DEDUP", "0")
    prog = program(receive_op(dedup=True, children=[send_op("gw_b", dedup=True)]))
    daemon = _daemon(tmp_path, prog)
    try:
        assert daemon.pump_procs == 2 and daemon.receiver.pump is not None
        senders = [op for op in daemon.operators if pump.is_pump_sender(op)]
        assert len(senders) == 1 and senders[0].pump_n == 2
        assert senders[0].dedup_index is not None and not daemon._dedup_indexes
        deadline = time.monotonic() + 60
        while len(daemon.receiver.pump.pool.live_workers()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        c = daemon._pump_counters()
        assert c["procs"] == 2 and c["workers_alive"] == 2 and c["worker_spawns"] == 2
    finally:
        daemon.api.stop()
        daemon.receiver.stop_all()
    assert all(not w.proc.is_alive() for w in daemon.receiver.pump.pool._workers)


def test_spawned_worker_reports_cpu_without_jax_or_cuda(tmp_path, monkeypatch):
    """A receiver pump worker spawned from this (jax-loaded) process, with the
    daemon's device variable set to ``cuda``, runs on the CPU: its pushed
    report names no jax, no JAX package and no CUDA context."""
    monkeypatch.setenv("SKYPLANE_GATEWAY_DEVICE", "cuda")
    monkeypatch.delenv(pump.PUMP_CHILD_PLATFORM_ENV, raising=False)
    errors = queue.Queue()
    cfg = {"role": "receiver", "gateway_id": "gw", "region": "local:local", "chunk_dir": str(tmp_path),
           "use_tls": False, "dedup": False, "cdc": (4096, 16384, 65536), "procs": 1, "push_s": 0.05}
    rp = pump.ReceiverPump(cfg, 1, gateway_id="gw", error_event=threading.Event(), error_queue=errors)
    try:
        deadline = time.monotonic() + 60
        report = None
        while report is None and time.monotonic() < deadline:
            live = rp.pool.live_workers()
            report = (live[0].counters or {}).get("runtime") if live else None
            time.sleep(0.05)
        assert errors.empty(), errors.get_nowait()
        assert report == {"device": "cpu", "cuda_initialized": False, "jax_loaded": False, "jax_package_loaded": False}
    finally:
        rp.stop()
