"""The port's gateway receiver against the JAX package's, on the CPU.

The deterministic scenario of ``tests/unit/test_decode_path.py`` (literals,
REFs to earlier literals, one unresolvable REF, over two connections) goes to
both receivers, with one decode worker and with the pool: the per-connection
ACK/NACK bytes and the landed chunk files must be equal (tolerance 0).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import uuid

import numpy as np
import pytest

from skyplane_tpu_torch.chunk import ChunkFlags, WireProtocolHeader
from skyplane_tpu_torch.gateway.operators.gateway_receiver import ACK_BYTE, DECODE_COUNTER_ZERO, NACK_UNRESOLVED
from skyplane_tpu_torch.ops import dedup as dedup_mod
from skyplane_tpu_torch.ops.dedup import SenderDedupIndex, build_recipe
from skyplane_tpu_torch.ops.fingerprint import segment_fingerprint_host
from tests.torch_gateway_util import jax_native_build_dir, pkg_ns  # noqa: F401 - autouse fixture


def _literal_frame(segments, chunk_id):
    wire, *_ = build_recipe(segments, SenderDedupIndex(), lambda b: b)
    raw = b"".join(s for _, s in segments)
    header = WireProtocolHeader(chunk_id=chunk_id, data_len=len(wire), raw_data_len=len(raw), flags=int(ChunkFlags.RECIPE))
    return header, wire, raw


def _ref_frame(fp, seg_len, raw, chunk_id):
    wire = dedup_mod.MAGIC + struct.pack("<BI", dedup_mod.VERSION, 1) + dedup_mod._ENTRY.pack(dedup_mod.KIND_REF, fp, seg_len)
    header = WireProtocolHeader(chunk_id=chunk_id, data_len=len(wire), raw_data_len=seg_len, flags=int(ChunkFlags.RECIPE))
    return header, wire, raw


def _scenario():
    """Two connections of five frames each, from a seeded corpus: two literal
    frames, a REF to the first (same connection), an unresolvable REF (NACK),
    and a REF to the second. Chunk ids are fixed, so both runs land the same
    file names."""
    rng = np.random.default_rng(2024)
    ids = iter(f"{i:032x}" for i in range(100))

    def seg(n):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        return segment_fingerprint_host(data), data

    conns = []
    for _ in range(2):
        s1, s2, s3 = seg(1200), seg(800), seg(600)
        conns.append([
            _literal_frame([s1, s2], next(ids)),
            _literal_frame([s3], next(ids)),
            _ref_frame(s1[0], len(s1[1]), s1[1], next(ids)),
            _ref_frame(b"\xee" * 16, 64, None, next(ids)),
            _ref_frame(s3[0], len(s3[1]), s3[1], next(ids)),
        ])
    return conns


def _send_frames(port, frames, timeout=10.0):
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        for header, wire, _ in frames:
            sock.sendall(header.to_bytes() + wire)
        resp = b""
        while len(resp) < len(frames):
            b = sock.recv(1)
            if not b:
                break
            resp += b
        return resp
    finally:
        sock.close()


def _run(pkg, tmp_path, decode_workers):
    ns = pkg_ns(pkg)
    store = ns.ChunkStore(str(tmp_path / f"rx_{pkg}_{uuid.uuid4().hex[:8]}"))
    ev = threading.Event()
    r = ns.GatewayReceiver(
        "local:local", store, ev, queue.Queue(), use_tls=False, bind_host="127.0.0.1", dedup=True,
        ref_wait_timeout=0.3, decode_workers=decode_workers, **ns.device_kw,
    )
    port = r.start_server()
    conns = _scenario()
    results = [None, None]
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _send_frames(port, conns[i])), daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        files = {}
        for frames in conns:
            for header, _, raw in frames:
                p = store.chunk_path(header.chunk_id)
                files[header.chunk_id] = (p.read_bytes() if p.exists() else None, p.with_suffix(".done").exists())
                if raw is not None:
                    assert files[header.chunk_id][0] == raw, f"{pkg}: restored bytes differ from the raw input"
        assert not ev.is_set(), f"{pkg}: the scenario killed the receiver"
        counters = r.decode_counters()
    finally:
        r.stop_all()
    return results, files, counters


@pytest.mark.parametrize("decode_workers", [1, 8])
def test_receiver_acks_and_files_equal_the_reference(tmp_path, decode_workers):
    port_resp, port_files, port_counters = _run("port", tmp_path, decode_workers)
    ref_resp, ref_files, ref_counters = _run("ref", tmp_path, decode_workers)
    expected = ACK_BYTE * 3 + NACK_UNRESOLVED + ACK_BYTE
    assert port_resp == ref_resp == [expected, expected]
    assert port_files == ref_files
    assert set(port_counters) == set(ref_counters) and set(DECODE_COUNTER_ZERO) <= set(port_counters)
    for k in ("decode_workers", "decode_chunks", "decode_raw_bytes", "decode_wire_bytes", "decode_nacks", "store_ref_timeouts"):
        assert port_counters[k] == ref_counters[k], k


def test_receiver_refuses_the_pump(tmp_path):
    """``enable_pump`` no longer refuses: it hands the receiver to two spawned
    pump workers, which report, retires the parent decode pool, and
    ``stop_all`` stops the workers."""
    import time

    ns = pkg_ns("port")
    r = ns.GatewayReceiver("local:local", ns.ChunkStore(str(tmp_path)), threading.Event(), queue.Queue(), use_tls=False, device="cpu")
    try:
        r.enable_pump(2)
        assert r.pump is not None and r._decode_threads == []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
            len(r.pump.pool.live_workers()) == 2 and all(w.counters for w in r.pump.pool.live_workers())
        ):
            time.sleep(0.05)
        assert [w.counters["runtime"]["device"] for w in r.pump.pool.live_workers()] == ["cpu", "cpu"]
        assert r.pump.counters()["workers_alive"] == 2
    finally:
        r.stop_all()
    assert r.pump is not None and not any(w.proc.is_alive() for w in r.pump.pool._workers)
