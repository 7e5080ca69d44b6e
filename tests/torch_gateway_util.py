"""Shared doubles for the port's gateway twin tests (``tests/test_torch_gateway_*.py``).

Each helper takes ``pkg``, ``"port"`` or ``"ref"``, and builds the same thing
from ``skyplane_tpu_torch`` (on the CPU) or from the JAX package, so one test
body drives both and compares their bytes.

``AckServer`` is a plain-TCP receiver double (the twin of the one in
``tests/unit/test_sender_pipeline.py``): it parses sender frames, logs
``(chunk_id, header bytes, payload)`` in arrival order, and answers per a
scripted policy.
"""

from __future__ import annotations

import importlib
import queue
import socket
import struct
import threading
import time
import uuid
from types import SimpleNamespace

import pytest

from skyplane_tpu_torch.chunk import HEADER_LENGTH_BYTES, WireProtocolHeader
from skyplane_tpu_torch.gateway.operators.gateway_receiver import ACK_BYTE
from skyplane_tpu_torch.ops import dedup as dedup_mod

_ROOTS = {"port": "skyplane_tpu_torch", "ref": "skyplane_tpu"}


def pkg_ns(pkg: str) -> SimpleNamespace:
    """The gateway classes of one package."""
    root = _ROOTS[pkg]
    chunk = importlib.import_module(f"{root}.chunk")
    op = importlib.import_module(f"{root}.gateway.operators.gateway_operator")
    rx = importlib.import_module(f"{root}.gateway.operators.gateway_receiver")
    return SimpleNamespace(
        pkg=pkg,
        Chunk=chunk.Chunk,
        ChunkRequest=chunk.ChunkRequest,
        ChunkState=chunk.ChunkState,
        ChunkStore=importlib.import_module(f"{root}.gateway.chunk_store").ChunkStore,
        GatewayQueue=importlib.import_module(f"{root}.gateway.gateway_queue").GatewayQueue,
        GatewaySenderOperator=op.GatewaySenderOperator,
        GatewayReadLocalOperator=op.GatewayReadLocalOperator,
        GatewayWaitReceiverOperator=op.GatewayWaitReceiverOperator,
        GatewayWriteLocalOperator=op.GatewayWriteLocalOperator,
        GatewayReceiver=rx.GatewayReceiver,
        CDCParams=importlib.import_module(f"{root}.ops.cdc").CDCParams,
        SenderDedupIndex=importlib.import_module(f"{root}.ops.dedup").SenderDedupIndex,
        DataPathProcessor=importlib.import_module(f"{root}.ops.pipeline").DataPathProcessor,
        device_kw={"device": "cpu"} if pkg == "port" else {},
    )


@pytest.fixture(scope="module", autouse=True)
def jax_native_build_dir(tmp_path_factory):
    """The JAX package's native loader writes its library and host tag beside
    its sources unless told otherwise: send any build of it to a temporary dir."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKYPLANE_TPU_NATIVE_BUILD_DIR", str(tmp_path_factory.mktemp("jax_native")))
        yield


class AckServer:
    """Plain-TCP receiver double. ``script(i, header, payload) -> bytes |
    "kill" | None`` where i is the global arrival index; None = receive but
    never respond (a stalled receiver). Default: ack everything."""

    def __init__(self, script=None, ack_delay_s: float = 0.0):
        self.script = script
        self.ack_delay_s = ack_delay_s
        self.lock = threading.Lock()
        self.frames = []  # (chunk_id, header bytes, payload) in arrival order
        self.conn_count = 0
        self._conns = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self.lock:
                self.conn_count += 1
                self._conns.append(conn)
            threading.Thread(target=self._conn, args=(conn,), daemon=True).start()

    @staticmethod
    def _recv_exact(conn, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            got = conn.recv(min(1 << 20, n - len(buf)))
            if not got:
                raise ConnectionError("peer closed mid-frame")
            buf += got
        return bytes(buf)

    def _conn(self, conn):
        try:
            while True:
                raw = self._recv_exact(conn, HEADER_LENGTH_BYTES)
                header = WireProtocolHeader.from_bytes(raw)
                payload = self._recv_exact(conn, header.data_len)
                with self.lock:
                    i = len(self.frames)
                    self.frames.append((header.chunk_id, raw, payload))
                action = self.script(i, header, payload) if self.script else ACK_BYTE
                if action == "kill":
                    return
                if action:
                    if self.ack_delay_s:
                        time.sleep(self.ack_delay_s)
                    conn.sendall(action)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def frame_log(self):
        with self.lock:
            return list(self.frames)

    def close(self):
        try:
            self._listener.close()
        except OSError:
            pass
        with self.lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def make_sender(pkg: str, tmp_path, port: int, *, dedup=True, n_workers=1, codec_name="none", **kw):
    """A sender operator of ``pkg`` wired straight at an AckServer: the control
    plane (/servers and chunk pre-registration) is stubbed out."""
    ns = pkg_ns(pkg)
    store = ns.ChunkStore(str(tmp_path / f"tx_{pkg}_{uuid.uuid4().hex[:8]}"))
    in_q, out_q = ns.GatewayQueue(), ns.GatewayQueue()
    out_q.register_handle("sink")
    error_event = threading.Event()
    kw = {**ns.device_kw, **kw}  # a caller's device= (the card tests) overrides the CPU default
    op = ns.GatewaySenderOperator(
        handle="send",
        region="test:r",
        input_queue=in_q,
        output_queue=out_q,
        error_event=error_event,
        error_queue=queue.Queue(),
        chunk_store=store,
        n_workers=n_workers,
        target_gateway_id="gw_test",
        target_host="127.0.0.1",
        target_control_port=0,
        codec_name=codec_name,
        dedup=dedup,
        use_tls=False,
        **kw,
    )

    def direct_socket():
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    op._make_socket = direct_socket
    op._register_batch = lambda batch: None
    return op, in_q, out_q, error_event, store


def stage_chunks(pkg: str, store, datas):
    ns = pkg_ns(pkg)
    reqs = []
    for i, data in enumerate(datas):
        cid = f"{i:032x}"
        store.chunk_path(cid).write_bytes(data)
        reqs.append(ns.ChunkRequest(chunk=ns.Chunk(src_key="s", dest_key="d", chunk_id=cid, chunk_length_bytes=len(data))))
    return reqs


def drain_n(out_q, n: int, timeout: float = 30.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        try:
            got.append(out_q.pop("sink", timeout=0.1))
        except queue.Empty:
            continue
    return got


def run_sender(pkg: str, tmp_path, datas, *, script=None, ack_delay_s=0.0, timeout=30.0, **kw):
    """Send ``datas`` through one sender of ``pkg``; returns the AckServer's
    frame log once every chunk completed."""
    server = AckServer(script=script, ack_delay_s=ack_delay_s)
    op, in_q, out_q, error_event, store = make_sender(pkg, tmp_path, server.port, **kw)
    try:
        for req in stage_chunks(pkg, store, datas):
            in_q.put(req)
        op.start_workers()
        done = drain_n(out_q, len(datas), timeout=timeout)
        assert len(done) == len(datas), f"{pkg} sender completed {len(done)} of {len(datas)} chunks"
        assert not error_event.is_set()
    finally:
        op.stop_workers()
        server.close()
    return server.frame_log()


def recipe_kinds(payload: bytes):
    """Entry kinds (0=REF, 1=LIT) of a recipe payload."""
    assert payload[: len(dedup_mod.MAGIC)] == dedup_mod.MAGIC
    _, n = struct.unpack_from("<BI", payload, len(dedup_mod.MAGIC))
    off = len(dedup_mod.MAGIC) + 5
    kinds = []
    for _ in range(n):
        kind, _fp, _size = dedup_mod._ENTRY.unpack_from(payload, off)
        kinds.append(kind)
        off += dedup_mod._ENTRY.size
    return kinds


def cross_pair(src: str, dst: str, root, *, sender_kw: dict, receiver_kw: dict):
    """A started direct program across two packages: ``src`` ("port" or "ref")
    gateway operators read local files and send; ``dst`` operators receive,
    land and write local files. It is the port's ``LoopbackPair`` (the wiring
    ``chip_smoke.py`` drives) with each side's classes from its own package."""
    from skyplane_tpu_torch.gateway.loopback import LoopbackPair

    s, d = pkg_ns(src), pkg_ns(dst)
    pair = LoopbackPair(
        root, sender_kw={**s.device_kw, **sender_kw}, receiver_kw={**d.device_kw, **receiver_kw},
        n_read=2, n_send=2, src=s, dst=d,
    )
    pair.start()
    return pair


def file_requests(pkg: str, files):
    """One chunk request of ``pkg`` per ``(src path, dest path, length)``."""
    ns = pkg_ns(pkg)
    return [
        ns.ChunkRequest(chunk=ns.Chunk(src_key=str(s), dest_key=str(d), chunk_id=uuid.uuid4().hex, chunk_length_bytes=n, file_offset_bytes=0))
        for s, d, n in files
    ]


def write_sources(root, datas):
    """Write ``datas`` as source files; returns [(src, dest, length)]."""
    (root / "src").mkdir(parents=True, exist_ok=True)
    (root / "dst").mkdir(parents=True, exist_ok=True)
    out = []
    for i, data in enumerate(datas):
        src = root / "src" / f"file{i}.bin"
        src.write_bytes(data)
        out.append((src, root / "dst" / f"file{i}.bin", len(data)))
    return out
