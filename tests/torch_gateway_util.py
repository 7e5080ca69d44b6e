"""Shared doubles for the port's gateway twin tests (``tests/test_torch_gateway_*.py``).

Each helper takes ``pkg``, ``"port"`` or ``"ref"``, and builds the same thing
from ``skyplane_tpu_torch`` (on the CPU) or from the JAX package, so one test
body drives both and compares their bytes.

``start_gateway`` and ``make_pair`` run either package's ``GatewayDaemon`` in
this process, talked to through the port's standard-library control client.

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


# ---- in-process daemons of either package (the twin of tests/integration/harness.py) ----


class LocalGateway:
    """One in-process gateway daemon of either package, driven through the
    port's standard-library control client."""

    def __init__(self, pkg: str, daemon, thread: threading.Thread):
        self.pkg = pkg
        self.daemon = daemon
        self.thread = thread

    @property
    def control_port(self) -> int:
        return self.daemon.api.port

    def url(self, route: str) -> str:
        scheme = "https" if self.daemon.control_tls else "http"
        return f"{scheme}://127.0.0.1:{self.control_port}/api/v1/{route}"

    def session(self):
        from skyplane_tpu_torch.gateway.control_auth import control_session

        return control_session(self.daemon.api_token)

    def get(self, route: str, **kw):
        return self.session().get(self.url(route), **kw)

    def post(self, route: str, **kw):
        return self.session().post(self.url(route), **kw)

    def sender(self):
        return next(op for op in self.daemon.operators if type(op).__name__ == "GatewaySenderOperator")

    def stop(self) -> None:
        self.daemon.stop()
        self.thread.join(timeout=10)


def start_gateway(pkg: str, program: dict, info: dict, gateway_id: str, chunk_dir, **kw) -> LocalGateway:
    """Start ``pkg``'s ``GatewayDaemon`` on a thread (control port 0 on
    127.0.0.1) and wait until its ``/status`` answers. A port daemon runs on
    the CPU unless ``device=`` is given."""
    from skyplane_tpu_torch.gateway.control_auth import ControlRequestError

    mod = importlib.import_module(f"{_ROOTS[pkg]}.gateway.gateway_daemon")
    kw = {**pkg_ns(pkg).device_kw, "region": "local:local", **kw}
    daemon = mod.GatewayDaemon(
        chunk_dir=str(chunk_dir), gateway_program=program, gateway_info=info, gateway_id=gateway_id,
        control_port=0, bind_host="127.0.0.1", **kw,
    )
    t = threading.Thread(target=daemon.run, name=f"daemon-{gateway_id}", daemon=True)
    t.start()
    gw = LocalGateway(pkg, daemon, t)
    for _ in range(100):
        try:
            gw.get("status", timeout=1)
            break
        except ControlRequestError:
            time.sleep(0.05)
    return gw


def program(*roots) -> dict:
    """A one-partition gateway program over ``roots``."""
    return {"plan": [{"partitions": ["default"], "value": list(roots)}]}


def receive_op(*, dedup=False, decrypt=False, children=None) -> dict:
    children = [{"op_type": "write_local", "handle": "write", "children": []}] if children is None else children
    return {"op_type": "receive", "handle": "recv", "decrypt": decrypt, "dedup": dedup, "children": children}


def send_op(target: str, *, compress="none", encrypt=False, dedup=False, num_connections=2, handle="send", **extra) -> dict:
    return {
        "op_type": "send", "handle": handle, "target_gateway_id": target, "region": "local:local",
        "num_connections": num_connections, "compress": compress, "encrypt": encrypt, "dedup": dedup,
        "children": [], **extra,
    }


def read_local_op(child: dict, num_connections: int = 2) -> dict:
    return {"op_type": "read_local", "handle": "read", "num_connections": num_connections, "children": [child]}


def make_pair(
    tmp, src_pkg: str = "port", dst_pkg: str = "port", *, compress="none", dedup=False, encrypt=False,
    use_tls=False, num_connections=2, api_token=None, key=None, src_kw=None, dst_kw=None, **send_extra,
):
    """Start a destination daemon of ``dst_pkg`` (receive -> write_local) and a
    source daemon of ``src_pkg`` (read_local -> send) wired to it, as the
    JAX package's ``make_pair`` does; returns ``(src, dst)``. ``src_kw`` and
    ``dst_kw`` go to each ``GatewayDaemon`` (``cdc_params``, ``batch_runner``,
    ``device``...); ``send_extra`` to the send op (``window``...)."""
    key = (bytes(range(32)) if key is None else key) if encrypt else None
    meta = {"api_token": api_token, "control_tls": use_tls} if api_token else None
    dst_info = {"_meta": meta} if meta else {}
    dst = start_gateway(
        dst_pkg, program(receive_op(dedup=dedup, decrypt=encrypt)), dst_info, "gw_dst", tmp / "dst_chunks",
        e2ee_key=key, use_tls=use_tls, **(dst_kw or {}),
    )
    info = {"gw_dst": {"public_ip": "127.0.0.1", "control_port": dst.control_port}}
    if meta:
        info["_meta"] = meta
    send = send_op("gw_dst", compress=compress, encrypt=encrypt, dedup=dedup, num_connections=num_connections, **send_extra)
    src = start_gateway(
        src_pkg, program(read_local_op(send, num_connections)), info, "gw_src", tmp / "src_chunks",
        e2ee_key=key, use_tls=use_tls, **(src_kw or {}),
    )
    return src, dst


def dispatch(src: LocalGateway, files, chunk_bytes=None):
    """POST chunk requests for ``[(src path, dest path, length)]`` to a source
    gateway (one request per file, or per ``chunk_bytes`` of it); returns their ids."""
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest

    reqs = []
    for s, d, n in files:
        step = chunk_bytes or max(n, 1)
        for off in range(0, max(n, 1), step):
            chunk = Chunk(src_key=str(s), dest_key=str(d), chunk_id=uuid.uuid4().hex,
                          chunk_length_bytes=min(step, n - off), file_offset_bytes=off)
            reqs.append(ChunkRequest(chunk=chunk, src_region="local:local", dst_region="local:local",
                                     src_type="local", dst_type="local"))
    resp = src.post("chunk_requests", json=[r.as_dict() for r in reqs], timeout=30)
    resp.raise_for_status()
    return [r.chunk.chunk_id for r in reqs]


def wait_complete(gw: LocalGateway, chunk_ids, timeout: float = 60.0) -> None:
    """Poll ``gw``'s ``/chunk_status_log`` until every id is complete; raise on
    a gateway error or the timeout."""
    deadline = time.monotonic() + timeout
    pending = set(chunk_ids)
    while time.monotonic() < deadline:
        status = gw.get("chunk_status_log", params={"chunk_ids": ",".join(sorted(pending))}, timeout=30).json()["chunk_status"]
        errs = gw.get("errors", timeout=30).json()["errors"]
        if errs:
            raise RuntimeError(f"gateway {gw.daemon.gateway_id} errors: {errs[0][:2000]}")
        pending = {c for c in pending if status.get(c) != "complete"}
        if not pending:
            return
        time.sleep(0.05)
    raise TimeoutError(f"{len(pending)}/{len(chunk_ids)} chunks incomplete at {gw.daemon.gateway_id}")


def stop_all(*gws) -> None:
    for gw in gws:
        try:
            gw.stop()
        except Exception:  # noqa: BLE001 — a drained daemon stopped itself
            pass


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
