"""The port's gateway sender against the JAX package's, on the CPU.

The same chunk set goes through each package's ``GatewaySenderOperator``
into the plain-TCP ``AckServer`` double; the ``(chunk_id, header bytes,
payload)`` sequences must be equal (tolerance 0: every output is bytes). The
port's pipelined wire engine must put the serial path's payloads on the
wire, and the deterministic sender contracts of
``tests/unit/test_sender_pipeline.py`` hold for the port: a mid-stream socket
kill re-queues the unacked chunks and commits none of their fingerprints, and
a NACK rolls back only the fingerprints its frame REF'd.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from skyplane_tpu_torch.gateway.operators.gateway_receiver import ACK_BYTE, NACK_UNRESOLVED
from skyplane_tpu_torch.gateway.operators.sender_wire import SENDER_WIRE_COUNTER_ZERO
from skyplane_tpu_torch.ops import dedup as dedup_mod
from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
from skyplane_tpu_torch.ops.pipeline import DataPathProcessor
from tests.torch_gateway_util import (  # noqa: F401 - jax_native_build_dir is an autouse fixture
    AckServer,
    drain_n,
    jax_native_build_dir,
    make_sender,
    recipe_kinds,
    run_sender,
    stage_chunks,
)


def _corpus(seed: int = 23):
    """Literals, a whole-chunk repeat (all REF, possibly against an unacked
    frame), a half repeat, and a zero run."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 96_000, dtype=np.uint8).tobytes()
    return [
        base,
        rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes(),
        base,
        base[:48_000] + rng.integers(0, 256, 16_000, dtype=np.uint8).tobytes(),
        bytes(40_000) + base[10_000:50_000],
    ]


@pytest.mark.parametrize("codec", ["none", "tpu", "native_lz"])
def test_serial_frames_equal_the_reference(tmp_path, codec):
    datas = _corpus()
    kw = dict(codec_name=codec, dedup=True, n_workers=1, pipelined=False, max_streams=1, window=len(datas))
    port = run_sender("port", tmp_path, datas, **kw)
    ref = run_sender("ref", tmp_path, datas, **kw)
    assert len(port) == len(ref) == len(datas)
    assert [cid for cid, _, _ in port] == [cid for cid, _, _ in ref], "frame order diverged"
    for (cid, hdr_p, pay_p), (_, hdr_r, pay_r) in zip(port, ref):
        assert hdr_p == hdr_r, f"{codec}: header bytes diverged for chunk {cid}"
        assert pay_p == pay_r, f"{codec}: payload bytes diverged for chunk {cid}"
    # the corpus really exercises REFs against an earlier, possibly unacked frame
    assert all(k == dedup_mod.KIND_REF for k in recipe_kinds(port[2][2]))


@pytest.mark.parametrize("codec", ["none", "tpu"])
def test_pipelined_frames_equal_serial(tmp_path, codec):
    """The pipelined engine's payloads equal the serial path's, in order,
    REF decisions against in-flight literals included (headers differ only
    in n_chunks_left_on_socket, 0 on a continuous stream, and its CRC)."""
    datas = _corpus(7)
    kw = dict(codec_name=codec, dedup=True, n_workers=1, max_streams=1, window=4)
    serial = run_sender("port", tmp_path, datas, pipelined=False, ack_delay_s=0.005, **kw)
    pipelined = run_sender("port", tmp_path, datas, pipelined=True, ack_delay_s=0.005, **kw)
    assert [cid for cid, _, _ in serial] == [cid for cid, _, _ in pipelined], "frame order diverged"
    for (cid, hs, ps), (_, hp, pp) in zip(serial, pipelined):
        assert ps == pp, f"wire bytes diverged for chunk {cid}"
        assert hs[:70] == hp[:70], f"header fields before n_chunks_left diverged for chunk {cid}"


def test_pipelined_counters_and_window_event(tmp_path):
    server = AckServer(ack_delay_s=0.005)
    op, in_q, out_q, _, store = make_sender("port", tmp_path, server.port, dedup=False, max_streams=1)
    try:
        rng = np.random.default_rng(3)
        datas = [rng.integers(0, 256, 32_000, dtype=np.uint8).tobytes() for _ in range(6)]
        for req in stage_chunks("port", store, datas):
            in_q.put(req)
        op.start_workers()
        assert len(drain_n(out_q, 6)) == 6
        counters = op.wire_counters()
        assert set(SENDER_WIRE_COUNTER_ZERO) <= set(counters)
        assert counters["acks_reaped"] == 6 and counters["frames_sent"] == 6
        assert counters["streams_open"] >= 1
        events = []
        while not op.socket_profile_events.empty():
            events.append(op.socket_profile_events.get_nowait())
        assert sum(e["n_acked"] for e in events) == 6
    finally:
        op.stop_workers()
        server.close()


def _expected_fps(datas):
    """Per-chunk new fingerprints via an identical offline data path."""
    proc = DataPathProcessor(codec_name="none", dedup=True, device="cpu")
    index = SenderDedupIndex()
    out = []
    for data in datas:
        p = proc.process(bytes(data), index)
        out.append([fp for fp, _ in p.new_fingerprints])
        for fp, size in p.new_fingerprints:
            index.add(fp, size)
    return out


def test_mid_stream_socket_kill_requeues_unacked_and_commits_nothing_uncommitted(tmp_path):
    """The socket dies after acking 2 of 5 frames and the receiver then
    stalls: acked chunks complete with their fps committed; un-acked chunks
    re-queue and resend, with none of their fps in the durable index."""
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, 48_000, dtype=np.uint8).tobytes() for _ in range(5)]
    fps = _expected_fps(datas)
    phase2 = threading.Event()

    def script(i, header, payload):
        if phase2.is_set():
            return None  # stalled receiver: swallow resends, never respond
        if i < 2:
            return ACK_BYTE
        phase2.set()
        return "kill"

    server = AckServer(script=script)
    op, in_q, out_q, _, store = make_sender("port", tmp_path, server.port, max_streams=1, window=5)
    try:
        for req in stage_chunks("port", store, datas):
            in_q.put(req)
        op.start_workers()
        done = drain_n(out_q, 2, timeout=15.0)
        assert sorted(r.chunk.chunk_id for r in done) == [f"{i:032x}" for i in range(2)]
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if phase2.is_set() and any(cid == f"{4:032x}" for cid, _, _ in server.frame_log()[3:]):
                break
            time.sleep(0.02)
        for fp in fps[0] + fps[1]:
            assert fp in op.dedup_index, "an acked chunk's fingerprints are missing from the durable index"
        for i in (2, 3, 4):
            for fp in fps[i]:
                assert fp not in op.dedup_index, f"un-acked chunk {i}'s fp leaked into the durable index"
        log = server.frame_log()
        for i in (0, 1):
            assert sum(1 for cid, _, _ in log if cid == f"{i:032x}") == 1, "an acked chunk was resent"
        assert server.conn_count >= 2
    finally:
        op.stop_workers()
        server.close()


def test_nack_mid_stream_rolls_back_only_affected_fps(tmp_path):
    """A NACK on a REF-carrying frame discards exactly the fps that frame
    REF'd: an unrelated acked chunk's fps survive, and the nacked chunk
    resends as pure literals."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes()
    c = rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes()
    datas = [a, c, a]  # chunk 2 REFs chunk 0's segments
    fps = _expected_fps(datas)
    ref_chunk = f"{2:032x}"
    nacked = threading.Event()

    def script(i, header, payload):
        if header.chunk_id == ref_chunk and not nacked.is_set():
            if any(k == dedup_mod.KIND_REF for k in recipe_kinds(payload)):
                nacked.set()
                return NACK_UNRESOLVED
        return ACK_BYTE

    server = AckServer(script=script)
    op, in_q, out_q, _, store = make_sender("port", tmp_path, server.port, max_streams=1, window=3)
    try:
        for req in stage_chunks("port", store, datas):
            in_q.put(req)
        op.start_workers()
        assert len(drain_n(out_q, 3)) == 3, "the nacked chunk never completed after the literal resend"
        assert nacked.is_set(), "scenario is vacuous: the REF frame was never nacked"
        sends = [payload for cid, _, payload in server.frame_log() if cid == ref_chunk]
        assert len(sends) == 2, "the nacked chunk was not resent exactly once"
        assert any(k == dedup_mod.KIND_REF for k in recipe_kinds(sends[0]))
        assert all(k == dedup_mod.KIND_LIT for k in recipe_kinds(sends[1])), "the resend still carried REFs"
        for fp in fps[0] + fps[1]:
            assert fp in op.dedup_index, "the rollback clobbered an unaffected chunk's fps"
        assert op.wire_counters()["nacks_reaped"] == 1
    finally:
        op.stop_workers()
        server.close()


def test_serial_nack_rolls_back_only_affected_fps(tmp_path):
    """The serial wire loop's NACK branch: the same rollback, same resend."""
    rng = np.random.default_rng(10)
    a = rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes()
    c = rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes()
    datas = [a, c, a]
    ref_chunk = f"{2:032x}"
    nacked = threading.Event()

    def script(i, header, payload):
        if header.chunk_id == ref_chunk and not nacked.is_set():
            nacked.set()
            return NACK_UNRESOLVED
        return ACK_BYTE

    frames = run_sender("port", tmp_path, datas, script=script, pipelined=False, max_streams=1, window=3)
    sends = [payload for cid, _, payload in frames if cid == ref_chunk]
    assert nacked.is_set() and len(sends) == 2
    assert all(k == dedup_mod.KIND_REF for k in recipe_kinds(sends[0]))
    assert all(k == dedup_mod.KIND_LIT for k in recipe_kinds(sends[1])), "the resend still carried REFs"
