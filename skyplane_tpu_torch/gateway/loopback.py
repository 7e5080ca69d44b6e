"""One direct gateway program on localhost, wired without a daemon.

The daemon and its control API (``gateway_daemon.py``, ``gateway_daemon_api.py``)
are the next slice of the port. Until then this module stands in for the two
things a sender needs from the destination's daemon:

- :class:`LoopbackControl` serves ``POST /api/v1/servers`` on localhost as the
  daemon API's handler does (a new receiver data port, the count of distinct
  sources, the segment store's capacity), so the sender's own
  ``_make_socket`` dials, negotiates and wraps TLS unchanged; and its
  :meth:`~LoopbackControl.register_batch` replaces
  ``GatewaySenderOperator._register_batch`` on an operator instance (as the
  JAX package's own tests replace it), landing each chunk request at the
  destination's chunk store as ``registered``, idempotently, with its hop
  advanced by one — what the API's ``/chunk_requests`` handler does.
- :class:`LoopbackPair` wires the operators of a direct program as
  ``GatewayDaemon._build_operators`` does: on the source, a partition's
  inbound queue -> ``GatewayReadLocalOperator`` -> ``GatewaySenderOperator``;
  on the destination, ``GatewayReceiver`` landing chunks, and the partition's
  inbound queue -> ``GatewayWaitReceiverOperator`` ->
  ``GatewayWriteLocalOperator``, whose output queue reports each chunk
  written to its destination file.

The daemon slice removes both.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, List, Optional

from skyplane_tpu_torch.chunk import ChunkRequest, ChunkState
from skyplane_tpu_torch.gateway.chunk_store import ChunkStore
from skyplane_tpu_torch.gateway.gateway_queue import GatewayQueue
from skyplane_tpu_torch.gateway.operators.gateway_operator import (
    GatewayReadLocalOperator,
    GatewaySenderOperator,
    GatewayWaitReceiverOperator,
    GatewayWriteLocalOperator,
)
from skyplane_tpu_torch.gateway.operators.gateway_receiver import GatewayReceiver

# The one partition of the program, and the daemon's worker counts for the
# destination's operators (``gateway_daemon.py`` ``_instantiate``).
PARTITION = "default"
N_WAIT = 4
N_WRITE = 4

# The classes one side of a pair is built from: this package's by default.
# A side given another package's namespace with the same names (a twin test's
# reference gateway) is wired the same way.
PORT_CLASSES = SimpleNamespace(
    ChunkRequest=ChunkRequest,
    ChunkState=ChunkState,
    ChunkStore=ChunkStore,
    GatewayQueue=GatewayQueue,
    GatewayReadLocalOperator=GatewayReadLocalOperator,
    GatewaySenderOperator=GatewaySenderOperator,
    GatewayWaitReceiverOperator=GatewayWaitReceiverOperator,
    GatewayWriteLocalOperator=GatewayWriteLocalOperator,
    GatewayReceiver=GatewayReceiver,
)


class LoopbackControl:
    """The destination's control API, as far as a sender uses it.

    ``receiver`` needs ``start_server()`` and ``segment_store``; ``register``
    lands one registration dict (``ChunkRequest.as_dict()`` form) at the
    destination's chunk store, with that package's classes.
    """

    def __init__(self, receiver, register: Callable[[dict], None], host: str = "127.0.0.1"):
        self.receiver = receiver
        self.host = host
        self._register = register
        self._lock = threading.Lock()
        self._registered: set = set()
        self._sources: set = set()
        control = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: tests and chip_smoke.py read their own logs
                pass

            def do_POST(self):
                if self.path.rstrip("/") != "/api/v1/servers":
                    self._send(404, {"error": f"not served by the loopback stand-in: {self.path}"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"null") if n else None
                self._send(200, control.open_server(body.get("source_gateway_id") if isinstance(body, dict) else None))

            def _send(self, code: int, obj: dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name="loopback-control", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def open_server(self, source_gateway_id: Optional[str]) -> dict:
        """The daemon API's ``/servers`` answer: a new data port on the receiver."""
        with self._lock:
            if source_gateway_id:
                self._sources.add(str(source_gateway_id))
            n_sources = len(self._sources)
        out = {"server_port": self.receiver.start_server(), "n_sources": n_sources}
        store = getattr(self.receiver, "segment_store", None)
        if store is not None:
            out["dedup_capacity_bytes"] = store.capacity_bytes
        return out

    def register_batch(self, batch: List) -> None:
        """Stands in for ``GatewaySenderOperator._register_batch``: each chunk
        request lands at the destination once (a re-registration of a known
        id is skipped, as the API's handler skips it), its hop advanced by one."""
        for req in batch:
            d = req.as_dict()
            d["chunk"]["hop"] = (req.chunk.hop or 0) + 1
            with self._lock:
                if req.chunk.chunk_id in self._registered:
                    continue
                self._registered.add(req.chunk.chunk_id)
            self._register(d)

    def attach(self, sender) -> None:
        """Point a sender operator (of either package) at this stand-in."""
        sender.target_host = self.host
        sender.target_control_port = self.port
        sender._register_batch = self.register_batch

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class LoopbackPair:
    """A source gateway's operators and a destination gateway's, in one
    process, for one partition: local source files -> sender -> TCP (TLS
    optional) -> receiver -> chunk store -> local destination files.

    ``sender_kw`` and ``receiver_kw`` go to ``GatewaySenderOperator`` and
    ``GatewayReceiver`` (codec, dedup, E2EE key, batch runner, device...).
    ``src`` and ``dst`` are the classes of each side (:data:`PORT_CLASSES`
    unless given). Read and send worker counts default to the daemon's
    (``gateway_daemon.py`` ``_instantiate``): read 8, send 16.
    """

    def __init__(
        self,
        root,
        *,
        sender_kw: dict,
        receiver_kw: dict,
        n_read: int = 8,
        n_send: int = 16,
        src: SimpleNamespace = PORT_CLASSES,
        dst: SimpleNamespace = PORT_CLASSES,
    ):
        root = Path(root)
        self.error_event = threading.Event()
        self.error_queue: "queue.Queue[str]" = queue.Queue()
        common = dict(error_event=self.error_event, error_queue=self.error_queue)

        # destination: receiver, then wait_receiver -> write_local
        self.dst_store = dst.ChunkStore(str(root / "dst_chunks"))
        dst_in = dst.GatewayQueue()
        self.dst_store.add_partition(PARTITION, dst_in)
        self.receiver = dst.GatewayReceiver("local:dst", self.dst_store, bind_host="127.0.0.1", gateway_id="dst", **common, **receiver_kw)
        written = dst.GatewayQueue()
        self.wait = dst.GatewayWaitReceiverOperator(
            handle="receive", region="local:dst", input_queue=dst_in, output_queue=dst.GatewayQueue(),
            chunk_store=self.dst_store, n_workers=N_WAIT, gateway_id="dst", **common,
        )
        self.write = dst.GatewayWriteLocalOperator(
            handle="write_local", region="local:dst", input_queue=self.wait.output_queue, output_queue=written,
            chunk_store=self.dst_store, n_workers=N_WRITE, gateway_id="dst", **common,
        )
        written.register_handle("done")
        self.written = written
        self.control = LoopbackControl(
            self.receiver, lambda d: self.dst_store.add_chunk_request(dst.ChunkRequest.from_dict(d), dst.ChunkState.registered)
        )

        # source: read_local -> send
        self.src_state = src.ChunkState
        self.src_store = src.ChunkStore(str(root / "src_chunks"))
        self.src_in = src.GatewayQueue()
        self.src_store.add_partition(PARTITION, self.src_in)
        self.read = src.GatewayReadLocalOperator(
            handle="read_local", region="local:src", input_queue=self.src_in, output_queue=src.GatewayQueue(),
            chunk_store=self.src_store, n_workers=n_read, gateway_id="src", **common,
        )
        self.sender = src.GatewaySenderOperator(
            handle="send", region="local:src", input_queue=self.read.output_queue, output_queue=None,
            chunk_store=self.src_store, n_workers=n_send, gateway_id="src",
            target_gateway_id="dst", target_host="127.0.0.1", target_control_port=0,
            source_gateway_id="src", **common, **sender_kw,
        )
        self.control.attach(self.sender)
        self.operators = [self.write, self.wait, self.sender, self.read]

    def start(self) -> None:
        for op in self.operators:
            op.start_workers()

    def submit(self, reqs: List[ChunkRequest]) -> None:
        for req in reqs:
            self.src_store.add_chunk_request(req, self.src_state.registered)

    def wait_written(self, n: int, timeout: float) -> List[ChunkRequest]:
        """Block until ``n`` chunks are written to their destination files, the
        timeout passes, or an operator fails; returns the written requests."""
        got: List[ChunkRequest] = []
        deadline = time.monotonic() + timeout
        while len(got) < n and time.monotonic() < deadline and not self.error_event.is_set():
            try:
                got.append(self.written.pop("done", timeout=0.05))
            except queue.Empty:
                continue
        return got

    def errors(self) -> List[str]:
        out = []
        while True:
            try:
                out.append(self.error_queue.get_nowait())
            except queue.Empty:
                return out

    def stop(self) -> None:
        for op in self.operators:
            op.stop_workers(timeout=5.0)
        self.receiver.stop_all()
        self.control.close()
