"""Receiver: TLS data-socket server landing chunks into the chunk store.

Reference parity: skyplane/gateway/operators/gateway_receiver.py:69-237 —
ephemeral listener ports created on demand via the control API, per-connection
handler, 4 MB recv_into pump, decrypt/decompress, chunk-file write + size
verify. Differences: handlers are threads; decode goes through
DataPathProcessor (codec dispatch from the wire header, dedup recipe
resolution against a SegmentStore with bounded ref-wait).

Decode architecture (the receiver mirror of the PR-2 sender overlap path):
each ``_conn_loop`` OWNS its socket — it reads ``(header, payload)`` frames,
hands the work to a decode pool shared by every connection, and writes the
per-connection acks/NACKs itself, strictly in submission order (the sender's
commit-on-ack and NACK-retry contracts depend on frame-ordered responses,
docs/wire_protocol.md; single-thread socket ownership because concurrent
SSL_read/SSL_write on one SSLSocket is not safe). Chunks decrypt/decode/
write OUT OF ORDER across the pool; a REF waiting for an in-flight literal
parks one pool worker, not the whole socket, and wakes via the
SegmentStore's per-fingerprint arrival event.

The port's receiver runs its processor on an explicit ``device`` (``"cuda"``
by default, as every port entry point; tests pass ``"cpu"``): with
``SKYPLANE_TPU_PARANOID_VERIFY=1`` and a batch runner, recipe chunks are
re-fingerprinted on the card. ``enable_pump`` hands accepted connections to
pump worker processes (gateway/pump.py), which build their receivers on the
device ``SKYPLANE_TPU_PUMP_CHILD_PLATFORM`` names (the CPU by default).

Why parked REFs cannot deadlock the pool: a correct sender only emits
REF(fp) after its LITERAL was (a) framed earlier on the SAME socket — and
the shared work queue is FIFO, so that literal task was dequeued before the
REF task — or (b) committed on ACK of another socket's chunk, i.e. already
fully decoded into the store. Either way the literal is never queued BEHIND
the parked REF; a hostile sender violating this burns its own
ref_wait_timeout into a NACK and eventually the nack budget, exactly the
stall profile of the old serial receiver.
"""

from __future__ import annotations

import json
import os
import queue
import selectors
import socket
import ssl
import threading
import time
import traceback
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

from skyplane_tpu_torch.chunk import WireProtocolHeader
from skyplane_tpu_torch.exceptions import DedupIntegrityException, SkyplaneTpuException
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.gateway.cert import generate_self_signed_certificate
from skyplane_tpu_torch.gateway.chunk_store import ChunkStore
from skyplane_tpu_torch.gateway.crypto import ChunkCipher
from skyplane_tpu_torch.obs import NOOP_SPAN, get_registry, get_tracer
from skyplane_tpu_torch.ops.dedup import PooledChunk, SegmentStore
from skyplane_tpu_torch.ops.pipeline import DataPathProcessor
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.obs import lockwitness as lockcheck

RECV_BLOCK = 4 * 1024 * 1024
ACK_BYTE = b"\x06"  # per-chunk delivery ack written back on the data socket
NACK_UNRESOLVED = b"\x15"  # REF in a recipe did not resolve: sender must resend literals

# stable decode-counter schema (receiver analog of DataPathStats.EXTERNAL_ZERO):
# every key is always present — zeros when a subsystem is off — so /profile
# dashboards, bench.py's decode section, and check_bench_json.py can rely on
# the shape without probing which subsystems are active.
DECODE_COUNTER_ZERO = {
    "decode_workers": 0,
    "decode_busy": 0,
    "decode_chunks": 0,
    "decode_raw_bytes": 0,
    "decode_wire_bytes": 0,
    "decode_nacks": 0,
    "decode_queue_depth": 0,
    "decode_ns": 0,
    # the port's stage timings of decoded chunks (ns; each the interval of
    # the span named beside it, docs/observability_torch.md): the frame's last
    # byte received -> a decode worker starting it (decode.queue), AES-GCM
    # open (decode.open), the codec/recipe restore (decode.restore), the
    # chunk-file landing (store.write); decode_ns spans the last three
    "decode_queue_ns": 0,
    "decode_open_ns": 0,
    "restore_ns": 0,
    "land_ns": 0,
    "store_mem_hits": 0,
    "store_spill_reads": 0,
    "store_promotions": 0,
    "store_lock_held_disk_reads": 0,
    "store_stripe_contention": 0,
    "store_ref_wait_ns": 0,
    "store_ref_timeouts": 0,
    "store_mem_evictions": 0,
    "store_spill_evictions": 0,
    "store_mem_bytes": 0,
    "store_spill_bytes": 0,
    "store_spill_adopted": 0,
    "store_spill_write_failures": 0,
    "pool_hits": 0,
    "pool_misses": 0,
    "pool_hit_rate": 0.0,
    "verify_total": 0,
    "verify_batched": 0,
    "decode_events_dropped": 0,
    "socket_events_dropped": 0,
}


def put_drop_oldest(q: "queue.Queue[dict]", event: dict) -> bool:
    """Best-effort put on a bounded profile-event queue: when full, drop the
    OLDEST event so a quiet profile endpoint keeps the freshest ones (shared
    by the receiver socket/decode profilers and the sender window profiler).

    Returns True when any event was lost (the oldest evicted, or — if the
    queue refilled under us — this event itself). Callers MUST surface the
    drop in a ``*_events_dropped`` counter: truncation used to be invisible
    and read as "profile covered everything" when it had not."""
    try:
        q.put_nowait(event)
        return False
    except queue.Full:
        pass
    dropped = False
    try:
        q.get_nowait()
        dropped = True
    except queue.Empty:
        pass
    try:
        q.put_nowait(event)
    except queue.Full:
        dropped = True  # refilled under us: this event is the casualty
    return dropped


class _DecodeTask:
    """One framed chunk handed from a connection's framing loop to the pool.
    ``recv_ns`` (perf_counter_ns) and ``recv_wall_ns`` stamp its last byte's
    arrival; ``span_parent`` is its ``frame.recv`` span (0 when untraced)."""

    __slots__ = (
        "header",
        "payload",
        "state",
        "done",
        "outcome",
        "detail",
        "raw_len",
        "decode_ns",
        "fpath",
        "recv_ns",
        "recv_wall_ns",
        "span_parent",
    )

    def __init__(self, header: WireProtocolHeader, payload: bytes, state: "_ConnState"):
        self.header = header
        self.payload = payload
        self.state = state
        self.recv_ns = time.perf_counter_ns()
        self.recv_wall_ns = 0
        self.span_parent = 0
        self.done = False  # set (under state.lock) when the worker finished
        self.outcome = "fatal"  # ack | nack | payload_error | fatal
        self.detail = ""
        self.raw_len = 0
        self.decode_ns = 0
        self.fpath = None  # landed chunk file; .done is touched at response time


class _ConnState:
    """Per-connection bookkeeping for the shared decode pool.

    ``pending`` holds tasks in FRAME ORDER; responses drain from its head
    only (the sender collects acks cumulatively in frame order). All mutable
    fields are guarded by ``lock``.

    Socket ownership: the FRAMING THREAD is the only thread that ever
    touches ``conn`` (recv, sendall, close) — it is also the only drainer,
    so response writes need no cross-thread serialization. Decode workers
    never write the socket (an SSLSocket shares one OpenSSL ``SSL*`` object,
    and concurrent SSL_read/SSL_write from different threads is not safe);
    they signal completion through ``wake_w`` (a socketpair the framing
    thread selects on alongside the data socket) and the ``drained``
    condition.
    """

    __slots__ = ("conn", "port", "lock", "drained", "pending", "dead", "wake_r", "wake_w", "selector")

    def __init__(self, conn: socket.socket, port: int):
        self.conn = conn
        self.port = port
        self.lock = lockcheck.wrap(threading.Lock(), "_ConnState.lock")
        self.drained = threading.Condition(self.lock)
        # sklint: disable=unbounded-queue-in-gateway -- depth is capped by the sender's byte-bounded in-flight window plus the bounded decode work queue's backpressure on the framing loop
        self.pending: "deque[_DecodeTask]" = deque()
        self.dead = False
        # wake channel (real sockets only): a completed decode nudges the
        # framing thread out of its readiness wait so the response goes out
        # now, not at the next frame arrival. Test doubles without fileno()
        # skip the wait entirely and drain at end-of-connection instead.
        # selectors.DefaultSelector (epoll/poll) rather than select.select:
        # a busy gateway can cross 1024 fds, where select() raises on any
        # larger fd and would wedge the connection's ack flow.
        self.wake_r = self.wake_w = None
        self.selector = None
        if hasattr(conn, "fileno"):
            self.wake_r, self.wake_w = socket.socketpair()
            self.wake_r.setblocking(False)
            self.wake_w.setblocking(False)
            self.selector = selectors.DefaultSelector()
            self.selector.register(conn, selectors.EVENT_READ, "conn")
            self.selector.register(self.wake_r, selectors.EVENT_READ, "wake")

    def wake(self) -> None:
        if self.wake_w is None:
            return
        try:
            self.wake_w.send(b"\x01")
        except OSError:
            pass  # wake already pending (buffer full) or conn torn down

    def close_wake(self) -> None:
        if self.selector is not None:
            try:
                self.selector.close()
            except OSError:
                pass
        for s in (self.wake_r, self.wake_w):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


class GatewayReceiver:
    def __init__(
        self,
        region: str,
        chunk_store: ChunkStore,
        error_event: threading.Event,
        error_queue: "queue.Queue[str]",
        recv_block_size: int = RECV_BLOCK,
        use_tls: bool = True,
        e2ee_key: Optional[bytes] = None,
        dedup: bool = False,
        segment_store: Optional[SegmentStore] = None,
        bind_host: str = "0.0.0.0",
        raw_forward: bool = False,
        cdc_params=None,
        ref_wait_timeout: float = 10.0,
        batch_runner=None,
        decode_workers: Optional[int] = None,
        tenant_registry=None,
        gateway_id: Optional[str] = None,
        ssl_cert_files=None,
        device="cuda",
    ):
        self.region = region
        # span identity on a merged fleet timeline: every receiver span
        # carries its gateway id so the collector can regroup events into
        # per-gateway Perfetto rows even when several harness gateways share
        # one process/tracer (docs/observability.md). The dict is shared by
        # every span (export copies args) — zero per-span allocation.
        self.gateway_id = gateway_id
        self._span_args = {"gateway": gateway_id} if gateway_id else None
        self.chunk_store = chunk_store
        self.error_event = error_event
        self.error_queue = error_queue
        self.recv_block_size = recv_block_size
        # multi-tenant accounting: decode bytes and NACKs are attributed to
        # the v5 wire header's tenant tag (docs/multitenancy.md); None keeps
        # the receiver single-tenant (bare test constructions)
        self.tenant_registry = tenant_registry
        self.use_tls = use_tls
        self._e2ee_key = e2ee_key  # raw key retained for pump worker configs
        self.cipher = ChunkCipher(e2ee_key) if e2ee_key else None
        # multi-process pump (gateway/pump.py): when attached via
        # enable_pump(), accepted connections are fd-passed to worker
        # processes instead of framed/decoded in this process
        self.pump = None
        self.segment_store = segment_store if segment_store is not None else (SegmentStore() if dedup else None)
        from skyplane_tpu_torch.ops.cdc import CDCParams

        # paranoid re-chunking MUST use the sender's CDC params or every valid
        # recipe would re-fingerprint differently and fail verification.
        # batch_runner (GPU gateways): paranoid verification of concurrent
        # decode workers micro-batches through the shared runner instead of
        # one blocking device call per chunk; a runner on another device
        # than ``device`` raises.
        self._cdc_params = cdc_params if cdc_params is not None else CDCParams()
        self.processor = DataPathProcessor(
            codec_name="none",
            dedup=dedup,
            cdc_params=self._cdc_params,
            paranoid_verify=os.environ.get("SKYPLANE_TPU_PARANOID_VERIFY") == "1",
            batch_runner=batch_runner,
            device=device,
        )
        self.bind_host = bind_host
        # how long a REF may wait for its in-flight LITERAL before nacking.
        # MUST stay well below the sender's 30 s data-socket timeout: a
        # waiting REF pins its pool worker AND (via the in-order response
        # contract) every later frame's ack on that socket; past the sender
        # timeout the whole window is reset+resent instead of the cheap
        # in-band nack.
        self.ref_wait_timeout = ref_wait_timeout
        # relay mode: payloads stay opaque (no decrypt/decode); the wire header
        # is persisted beside the chunk so the forwarding sender can re-frame
        # it unchanged (reference: relays forward without decrypt/decompress)
        self.raw_forward = raw_forward
        self._servers: Dict[int, socket.socket] = {}
        self._threads: List[threading.Thread] = []
        self._lock = lockcheck.wrap(threading.Lock(), "GatewayReceiver._lock")
        # payload errors (bad codec/recipe/checksum from a peer) drop the
        # connection rather than killing the daemon — a hostile or corrupted
        # frame must not be a gateway DoS. Persistent corruption escalates.
        self._payload_error_count = 0
        self.max_payload_errors = 20
        # bounded: a daemon nobody profiles must not accumulate events forever;
        # drops are counted (never silent) and surfaced on the endpoints
        self.socket_profile_events: "queue.Queue[dict]" = queue.Queue(maxsize=4096)
        self.decode_profile_events: "queue.Queue[dict]" = queue.Queue(maxsize=4096)
        self._socket_events_dropped = 0
        self._decode_events_dropped = 0
        # unified-registry latency distribution (GET /api/v1/metrics); the
        # ad-hoc decode_ns counter only gives a mean
        self._decode_hist = get_registry().histogram(
            "decode_seconds", help_="per-chunk receiver decode latency (decrypt + decode + land)"
        )
        # unresolvable-REF nacks are an EXPECTED, recoverable condition (the
        # sender discards fps and resends literals) — budget them separately
        # from corruption, with a higher cap, also reset on any success
        self._nack_count = 0
        self.nacks_total = 0  # cumulative, never reset: observability + tests
        self.max_nacks = 200
        # ---- shared decode worker pool ----
        if decode_workers is None:
            try:
                decode_workers = int(os.environ.get("SKYPLANE_TPU_DECODE_WORKERS", "0"))
            except ValueError:
                logger.fs.warning("ignoring malformed SKYPLANE_TPU_DECODE_WORKERS")
                decode_workers = 0
            if decode_workers == 1:
                # the floor of 2 is a documented invariant, not a default: a
                # single worker parked on a REF wait would starve the very
                # literal decode that could wake it (env path only — the
                # explicit constructor arg may pick 1 for serial-mode tests)
                logger.fs.warning("SKYPLANE_TPU_DECODE_WORKERS=1 raised to the floor of 2 (REF-wait starvation)")
                decode_workers = 2
        decode_workers = int(decode_workers)
        if decode_workers <= 0:
            # auto-size (explicit 0/negative means auto, matching the env convention)
            decode_workers = max(2, min(8, os.cpu_count() or 1))
        # bounded work queue = backpressure: framing loops block (and TCP
        # flow-control pushes back on senders) instead of buffering payloads
        self._work_q: "queue.Queue[Optional[_DecodeTask]]" = queue.Queue(maxsize=max(2 * decode_workers, 8))
        self._stats_lock = lockcheck.wrap(threading.Lock(), "GatewayReceiver._stats_lock")
        self._decode_stats = {
            "decode_chunks": 0,
            "decode_raw_bytes": 0,
            "decode_wire_bytes": 0,
            "decode_busy": 0,
            "decode_ns": 0,
            "decode_queue_ns": 0,
            "decode_open_ns": 0,
            "restore_ns": 0,
            "land_ns": 0,
        }
        self._decode_threads: List[threading.Thread] = []
        for i in range(decode_workers):
            t = threading.Thread(target=self._decode_worker, name=f"receiver-decode-{i}", daemon=True)
            t.start()
            self._decode_threads.append(t)
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        self._ssl_cert_files: Optional[tuple] = None
        if use_tls:
            if ssl_cert_files is not None:
                # pump worker processes load the parent's on-disk cert pair:
                # regenerating here would race sibling workers over the files
                cert, key = ssl_cert_files
            else:
                cert_dir = Path(chunk_store.chunk_dir) / "certs"
                cert, key = generate_self_signed_certificate(
                    "skyplane-tpu-gateway", cert_dir / "cert.pem", cert_dir / "key.pem"
                )
            self._ssl_cert_files = (str(cert), str(key))
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(certfile=str(cert), keyfile=str(key))

    def enable_pump(self, procs: int, persist_dedup: bool = False) -> None:
        """Shard this receiver's decode path across ``procs`` worker
        processes (gateway/pump.py): accepts stay here, every accepted
        socket is fd-passed to a worker that owns it end to end. Call before
        the first start_server()."""
        from skyplane_tpu_torch.gateway.pump import PUMP_PUSH_S_ENV, ReceiverPump

        cfg = {
            "role": "receiver",
            "gateway_id": self.gateway_id or "gateway",
            "region": self.region,
            "chunk_dir": str(self.chunk_store.chunk_dir),
            "use_tls": self.use_tls,
            "ssl_cert_files": list(self._ssl_cert_files) if self._ssl_cert_files else None,
            "e2ee_key": list(self._e2ee_key) if self._e2ee_key else None,
            "dedup": self.segment_store is not None,
            "persist_dedup": persist_dedup,
            "raw_forward": self.raw_forward,
            "cdc": (self._cdc_params.min_bytes, self._cdc_params.avg_bytes, self._cdc_params.max_bytes),
            "ref_wait_timeout": self.ref_wait_timeout,
            "decode_workers": max(2, len(self._decode_threads) // max(1, procs)),
            "procs": int(procs),
            "push_s": float(os.environ.get(PUMP_PUSH_S_ENV, "0.25") or 0.25),
        }
        self.pump = ReceiverPump(
            cfg,
            procs,
            gateway_id=self.gateway_id or "gateway",
            error_event=self.error_event,
            error_queue=self.error_queue,
            # workers tally per-tenant decode/nack attribution; the pump
            # replays the deltas into the daemon's real registry
            tenant_registry=self.tenant_registry,
        )
        # the parent decode pool can never receive work once every accepted
        # socket is fd-passed to a worker: retire it (idle threads would also
        # skew the muxed decode_workers gauge to parent+workers summed). The
        # parent SegmentStore stays — /servers still advertises its capacity
        # and the daemon's shutdown spill/adoption contract reads it — but it
        # holds no resident segments in pump mode (nothing decodes here).
        for _ in self._decode_threads:
            try:
                self._work_q.put_nowait(None)
            except queue.Full:
                break
        for t in self._decode_threads:
            t.join(timeout=2.0)
        self._decode_threads = []

    def start_server(self) -> int:
        """Bind a new ephemeral data port; returns the port (reference :69-114)."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.bind_host, 0))
            sock.listen(64)
            port = sock.getsockname()[1]
        except BaseException:
            # bind/listen can fail under fd pressure or address exhaustion;
            # the control plane retries /servers, so the leak would compound
            sock.close()
            raise
        with self._lock:
            self._servers[port] = sock
        t = threading.Thread(target=self._accept_loop, args=(sock, port), name=f"receiver-accept-{port}", daemon=True)
        t.start()
        self._threads.append(t)
        logger.fs.info(f"[receiver] listening on {self.bind_host}:{port}")
        return port

    def stop_server(self, port: int) -> bool:
        with self._lock:
            sock = self._servers.pop(port, None)
        if sock is None:
            return False
        try:
            sock.close()
        except OSError:
            pass
        return True

    def stop_all(self) -> None:
        with self._lock:
            ports = list(self._servers)
        for p in ports:
            self.stop_server(p)
        if self.pump is not None:
            self.pump.stop()
        # sentinels queue BEHIND any in-flight tasks, so workers finish real
        # work first; the receiver is single-use after stop_all. Best-effort:
        # a full queue means workers are still draining real tasks — they are
        # daemon threads, so a missed sentinel only leaves an idle thread.
        for _ in self._decode_threads:
            try:
                self._work_q.put_nowait(None)
            except queue.Full:
                break

    def _accept_loop(self, server_sock: socket.socket, port: int) -> None:
        while not self.error_event.is_set():
            try:
                conn, addr = server_sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.pump is not None:
                # multi-process pump: the raw accepted socket crosses to a
                # worker process (socket.send_fds); TLS handshake, framing
                # and decode all run there
                self.pump.dispatch_connection(conn, port)
                continue
            self.adopt_connection(conn, port, addr=addr)

    def adopt_connection(self, conn: socket.socket, port: int, addr=None) -> bool:
        """Serve one already-accepted TCP connection: TLS handshake (when
        configured) + a dedicated framing thread. Shared by the in-process
        accept loop and pump worker processes adopting fd-passed sockets."""
        if self._ssl_ctx is not None:
            try:
                conn = self._ssl_ctx.wrap_socket(conn, server_side=True)
            except (ssl.SSLError, OSError) as e:
                logger.fs.warning(f"[receiver:{port}] TLS handshake failed from {addr}: {e}")
                try:
                    conn.close()
                except OSError:
                    pass
                return False
        t = threading.Thread(target=self._conn_loop, args=(conn, port), name=f"receiver-conn-{port}", daemon=True)
        t.start()
        self._threads.append(t)
        return True

    # ---- framing loop (one per connection) ----

    def _conn_loop(self, conn: socket.socket, port: int) -> None:
        """Pump frames off one connection into the decode pool until the peer
        closes (reference :142-237). This thread OWNS the socket: it reads
        frames AND writes the in-order responses for decodes the pool has
        finished (select on the data socket + the pool's wake channel), so no
        other thread ever touches the (TLS) socket."""
        state = _ConnState(conn, port)
        try:
            while not self.error_event.is_set():
                self._drain_responses(state)
                with state.lock:
                    dead = state.dead
                if dead:
                    break  # a drained payload error / fatal already dropped the conn
                if state.wake_r is not None and not self._wait_readable(state):
                    continue  # woke for finished decodes (or idle tick): drain and re-check
                try:
                    header = WireProtocolHeader.from_socket(conn)
                except (ConnectionError, OSError):
                    break  # clean peer close
                t0 = time.time()
                tracer = get_tracer()
                recv_span = (
                    tracer.span(
                        "frame.recv",
                        trace_id=header.chunk_id,
                        cat="receiver",
                        force=header.is_traced,
                        args=self._span_args,
                    )
                    if tracer.enabled
                    else NOOP_SPAN
                )
                try:
                    with recv_span:
                        payload = self._recv_exact(conn, header.data_len)
                        recv_parent = tracer.current_span_id()  # handed to the decode worker
                except (ConnectionError, OSError) as e:
                    # peer died mid-payload (e.g. sender resetting a broken socket
                    # before retrying) — drop the partial chunk, it will be re-sent
                    logger.fs.warning(f"[receiver:{port}] connection lost mid-chunk {header.chunk_id}: {e}")
                    break
                if put_drop_oldest(
                    self.socket_profile_events,
                    {"port": port, "chunk_id": header.chunk_id, "bytes": header.data_len, "time_s": time.time() - t0},
                ):
                    with self._lock:
                        self._socket_events_dropped += 1
                task = _DecodeTask(header, payload, state)
                if recv_parent:
                    task.span_parent, task.recv_wall_ns = recv_parent, time.time_ns()
                with state.lock:
                    if state.dead:
                        break
                    state.pending.append(task)
                self._work_q.put(task)  # blocks when the pool is saturated (backpressure)
        except SkyplaneTpuException as e:
            # malformed frame header from the peer: drop this connection
            # (no ack was sent, so the sender re-queues the chunk). Repeated
            # payload errors indicate systemic corruption -> fail the daemon.
            logger.fs.warning(f"[receiver:{port}] dropping connection on bad frame: {e}")
            self._count_payload_error(traceback.format_exc())
        except MemoryError as e:
            # an oversized (but header-cap-passing) allocation failed: hostile
            # or corrupt frames must not be a daemon DoS — payload error path
            logger.fs.warning(f"[receiver:{port}] dropping connection on allocation failure: {e}")
            self._count_payload_error(f"MemoryError receiving payload: {e}")
        except (ssl.SSLError, ConnectionError, TimeoutError) as e:
            # the PEER failed or abandoned the connection mid-stream — routine
            # on a WAN and under load; connection-level cleanup, never fatal
            logger.fs.warning(f"[receiver:{port}] connection lost mid-stream: {e}")
        except Exception:  # noqa: BLE001 — unexpected receiver error stops the daemon
            tb = traceback.format_exc()
            logger.fs.error(f"[receiver:{port}] fatal: {tb}")
            self.error_queue.put(tb)
            self.error_event.set()
        finally:
            # let in-flight decodes finish and their acks/NACKs drain before
            # the socket closes: the framing loop exiting must never strand a
            # decoded chunk's response (the sender would needlessly resend).
            # This runs past the except handlers above, so a local failure in
            # the drain (e.g. ENOSPC touching a .done marker) must escalate
            # to the daemon-fatal path here — not die with the thread.
            try:
                self._finalize_conn(state, self.ref_wait_timeout + 30.0)
            except Exception:  # noqa: BLE001 — same fatal semantics as the loop body
                tb = traceback.format_exc()
                logger.fs.error(f"[receiver:{port}] fatal during connection drain: {tb}")
                self.error_queue.put(tb)
                self.error_event.set()
            with state.lock:
                state.dead = True
            state.close_wake()
            try:
                conn.close()
            except OSError:
                pass

    # ---- decode pool ----

    def _decode_worker(self) -> None:
        while True:
            task = self._work_q.get()
            if task is None:
                return  # stop_all sentinel
            with self._stats_lock:
                self._decode_stats["decode_busy"] += 1
            try:
                self._process_task(task)
            finally:
                with self._stats_lock:
                    self._decode_stats["decode_busy"] -= 1
                # the wire payload is consumed (chunk landed / outcome set):
                # drop it NOW — a parked head-of-line REF must not pin every
                # completed frame's multi-MB payload behind it in pending
                task.payload = b""
                # publish completion and nudge the socket-owning framing
                # thread — workers never write the (TLS) socket themselves
                with task.state.lock:
                    task.done = True
                    task.state.drained.notify_all()
                task.state.wake()

    @staticmethod
    def _land(fpath: Path, data) -> None:
        """Atomically land chunk bytes: write to a worker-unique temp file and
        rename into place. A resend of the same chunk on a NEW connection can
        race a stale queued decode from the dead one — os.replace guarantees
        a downstream reader (gated on .done) never sees a truncated file, and
        either writer's content is identical (same chunk id, same bytes)."""
        tmp = fpath.with_name(f"{fpath.name}.tmp{threading.get_ident()}")
        tmp.write_bytes(data)
        os.replace(tmp, fpath)

    def _timed(self, name: str, key: str, header: WireProtocolHeader, times: dict):
        """A decode stage timed into ``times[key]`` and, for a traced chunk,
        into its span under the chunk's decode span."""
        return get_tracer().timed(
            name, times.__setitem__, key, trace_id=header.chunk_id, cat="receiver", force=header.is_traced,
            args=self._span_args,
        )

    def _process_task(self, task: _DecodeTask) -> None:
        """Decrypt/decode/land one chunk; record the outcome for the in-order
        response drain. Never raises — every failure maps to an outcome."""
        header, state = task.header, task.state
        t0 = time.perf_counter_ns()
        queue_ns = t0 - task.recv_ns
        # this chunk's stage timings, added to the decode counters once it landed
        times = {"decode_queue_ns": queue_ns, "decode_open_ns": 0, "restore_ns": 0, "land_ns": 0}
        tracer = get_tracer()
        # the sender's TRACED header flag forces the span past the local
        # sampling decision: both sides of the wire trace the SAME chunks
        if tracer.enabled:
            if task.span_parent:
                tracer.record_span(
                    "decode.queue",
                    queue_ns,
                    task.recv_wall_ns,
                    trace_id=header.chunk_id,
                    cat="receiver",
                    force=header.is_traced,
                    args=self._span_args,
                    parent=task.span_parent,
                )
            span = tracer.span(
                "decode",
                trace_id=header.chunk_id,
                cat="receiver",
                force=header.is_traced,
                args=self._span_args,
                parent=task.span_parent,
            )
        else:
            span = NOOP_SPAN
        try:
          with span:
            with state.lock:
                dead = state.dead
            if dead:
                # connection already dropped (no response will ever be sent):
                # don't land the chunk — the sender is resending it on a new
                # connection and this stale write would race that decode
                task.outcome = "drop"
                return
            fpath = self.chunk_store.chunk_path(header.chunk_id)
            if self.raw_forward:
                with self._timed("store.write", "land_ns", header, times):
                    self._land(fpath, task.payload)
                    self._land(
                        fpath.with_suffix(".hdr"),
                        json.dumps(
                            {
                                "codec": header.codec,
                                "flags": header.flags,
                                "fingerprint": header.fingerprint,
                                "raw_data_len": header.raw_data_len,
                                "tenant": header.tenant_id,
                            }
                        ).encode(),
                    )
            else:
                # E2EE is all-or-nothing per receiver: when a key is
                # configured, EVERY frame must be encrypted and MUST
                # authenticate. The ENCRYPTED flag is attacker-controlled
                # (header CRC is unkeyed), so a cleared flag cannot be
                # allowed to bypass cipher.open() — a peer that reaches
                # the data port would otherwise inject plaintext frames.
                payload = task.payload
                if self.cipher is not None:
                    if not header.is_encrypted:
                        raise SkyplaneTpuException(
                            f"unencrypted frame for chunk {header.chunk_id} at E2EE-enabled receiver"
                        )
                    with self._timed("decode.open", "decode_open_ns", header, times):
                        payload = self.cipher.open(payload)
                elif header.is_encrypted:
                    raise SkyplaneTpuException("received encrypted chunk but no E2EE key configured")
                try:
                    inj = get_injector()
                    if inj.enabled:
                        # decode-worker fault (docs/fault-injection.md): lands
                        # on the in-band NACK path — the sender discards the
                        # affected fps and resends literals, the connection
                        # stays up (the cheapest recovery contract)
                        inj.check("receiver.decode_nack", DedupIntegrityException, "injected decode fault")
                    with self._timed("decode.restore", "restore_ns", header, times):
                        data = self.processor.restore(
                            payload,
                            header,
                            store=self.segment_store,
                            ref_wait_timeout=self.ref_wait_timeout,
                            pooled=True,
                        )
                except DedupIntegrityException as e:
                    # a REF pointed at a segment this receiver no longer
                    # holds (evicted / never arrived). The stream is still
                    # framed correctly, so nack in-band: the sender drops
                    # those fingerprints and retries with literals. Do NOT
                    # drop the connection — that would just replay the
                    # same unresolvable recipe forever.
                    task.outcome, task.detail = "nack", str(e)
                    if self.tenant_registry is not None:
                        self.tenant_registry.note_nack(header.tenant_id)
                    logger.fs.warning(f"[receiver:{state.port}] nacking chunk {header.chunk_id}: {e}")
                    return
                # zero-copy handoff: a pooled view goes straight to the chunk
                # file and the buffer recycles for the next decode
                with self._timed("store.write", "land_ns", header, times):
                    self._land(fpath, data.view if isinstance(data, PooledChunk) else data)
                if isinstance(data, PooledChunk):
                    data.release()
            # .done is NOT touched here: with out-of-order decode, chunks
            # landed behind a frame whose in-order response later fails would
            # otherwise be exposed to downstream operators and then REWRITTEN
            # by the sender's resend. The marker is touched in _finish_task,
            # when this chunk's response actually commits in frame order.
            task.fpath = fpath
            task.outcome = "ack"
            task.raw_len = header.raw_data_len
            task.decode_ns = time.perf_counter_ns() - t0
            if self.tenant_registry is not None:
                self.tenant_registry.note_decoded(header.tenant_id, header.raw_data_len)
            with self._stats_lock:
                self._decode_stats["decode_chunks"] += 1
                self._decode_stats["decode_raw_bytes"] += header.raw_data_len
                self._decode_stats["decode_wire_bytes"] += header.data_len
                self._decode_stats["decode_ns"] += task.decode_ns
                for key, ns in times.items():
                    self._decode_stats[key] += ns
            self._decode_hist.observe(task.decode_ns / 1e9)
            if put_drop_oldest(
                self.decode_profile_events,
                {
                    "port": state.port,
                    "chunk_id": header.chunk_id,
                    "raw_bytes": header.raw_data_len,
                    "wire_bytes": header.data_len,
                    "decode_s": round(task.decode_ns / 1e9, 6),
                },
            ):
                with self._stats_lock:
                    self._decode_events_dropped += 1
            logger.fs.debug(
                f"[receiver:{state.port}] landed chunk {header.chunk_id} "
                f"({header.raw_data_len}B raw, {header.data_len}B wire)"
            )
        except SkyplaneTpuException:
            # malformed/corrupt payload from the peer: the drain drops this
            # connection (no ack sent -> the sender re-queues the chunk)
            task.outcome, task.detail = "payload_error", traceback.format_exc()
        except MemoryError as e:
            task.outcome, task.detail = "payload_error", f"MemoryError decoding payload: {e}"
        except Exception:  # noqa: BLE001 — unexpected decode error stops the daemon
            # includes local OSErrors (e.g. ENOSPC writing the chunk file),
            # which are deliberately daemon-fatal, exactly as before
            task.outcome, task.detail = "fatal", traceback.format_exc()

    def _drain_responses(self, state: _ConnState) -> None:
        """Send acks/NACKs for completed tasks at the HEAD of a connection's
        pending queue, preserving frame order. Runs ONLY in the connection's
        socket-owning framing thread (the _ConnState ownership invariant),
        so draining needs no cross-thread serialization; the socket write
        still happens outside the lock so a slow peer receive window never
        blocks workers publishing completions."""
        while True:
            with state.lock:
                if not state.pending or not state.pending[0].done:
                    return
                task = state.pending.popleft()
                dead = state.dead
            self._finish_task(state, task, dead)

    def _finish_task(self, state: _ConnState, task: _DecodeTask, dead: bool) -> None:
        """Act on one completed head-of-line task (no state.lock held)."""
        if dead:
            return  # connection already dropped: no response; sender re-queues
        if task.outcome == "ack":
            # expose the chunk to downstream operators only now, at in-order
            # response commit (see _process_task) — and strictly BEFORE the
            # ack goes out, so an acked chunk always has its .done marker
            if task.fpath is not None:
                task.fpath.with_suffix(".done").touch()
            # count BEFORE the wire write: a peer that reads the response and
            # immediately polls counters must never observe the pre-response
            # state (budget resets are rate bookkeeping, not delivery proof)
            self._note_success()
            inj = get_injector()
            if inj.enabled and inj.fire("receiver.ack_delay"):
                # docs/fault-injection.md: hold the ack without dropping it —
                # a congested/struggling hop as the sender's ack_lag counters
                # see it. This is what drives the replan monitor's
                # ack-lag-dominant signal deterministically in chaos runs.
                time.sleep(0.05)
            try:
                # application-level ack: the sender commits dedup fingerprints
                # and marks the chunk complete only after this lands — TCP
                # sendall() alone proves nothing about delivery
                state.conn.sendall(ACK_BYTE)
            except OSError as e:  # ssl.SSLError/Timeout included: peer abandoned us
                logger.fs.warning(f"[receiver:{state.port}] connection lost writing ack: {e}")
                self._kill_conn(state)
                return
        elif task.outcome == "nack":
            self._count_nack(task.detail)
            try:
                state.conn.sendall(NACK_UNRESOLVED)
            except OSError as e:
                logger.fs.warning(f"[receiver:{state.port}] connection lost writing nack: {e}")
                self._kill_conn(state)
                return
        elif task.outcome == "payload_error":
            logger.fs.warning(f"[receiver:{state.port}] dropping connection on bad payload: {task.detail.splitlines()[-1] if task.detail else ''}")
            self._kill_conn(state)
            self._count_payload_error(task.detail)
        elif task.outcome == "fatal":
            logger.fs.error(f"[receiver:{state.port}] fatal: {task.detail}")
            self._kill_conn(state)
            self.error_queue.put(task.detail)
            self.error_event.set()
        # "drop": worker observed the connection dead and landed nothing

    def _kill_conn(self, state: _ConnState) -> None:
        with state.lock:
            state.dead = True
        try:
            state.conn.close()
        except OSError:
            pass

    def _wait_readable(self, state: _ConnState) -> bool:
        """Block until the data socket has frame bytes (True) or a decode
        completed / idle tick fired (False -> caller drains and re-checks).
        Runs only in the socket-owning framing thread."""
        conn = state.conn
        pending = getattr(conn, "pending", None)
        if pending is not None and conn.pending():
            return True  # TLS bytes already decrypted into the SSL buffer
        try:
            # 0.2s idle tick: wakes are event-driven (wake channel / frame
            # bytes); the tick only bounds error_event latency and the cost
            # of any wake the OS drops, without a measurable idle burn
            events = state.selector.select(0.2)
        except (OSError, ValueError):
            return True  # socket torn down under us: let from_socket surface it
        ready = {key.data for key, _ in events}
        if "wake" in ready:
            try:
                state.wake_r.recv(4096)  # drain wake tokens
            except OSError:
                pass
        return "conn" in ready

    def _finalize_conn(self, state: _ConnState, timeout: float) -> None:
        """End-of-connection: drain responses for in-flight decodes until the
        pending queue empties (or the timeout expires on a stuck decode).
        Still the socket-owning thread — responses go out from here."""
        deadline = time.monotonic() + timeout
        while True:
            self._drain_responses(state)
            with state.lock:
                if not state.pending:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return  # stuck decode: close anyway; late responses are discarded
                if not state.pending[0].done:
                    state.drained.wait(min(remaining, 0.5))

    def _note_success(self) -> None:
        with self._lock:
            # successful chunks reset the payload-error budget: the
            # escalation threshold is a corruption RATE, not a
            # lifetime total that would kill long-lived daemons over
            # isolated transients
            self._payload_error_count = 0
            self._nack_count = 0

    def _count_payload_error(self, detail: str) -> None:
        """Bump the payload-error budget; escalate to daemon failure at the cap."""
        with self._lock:
            self._payload_error_count += 1
            count = self._payload_error_count
        if count >= self.max_payload_errors:
            self.error_queue.put(f"receiver exceeded {self.max_payload_errors} payload errors; last: {detail}")
            self.error_event.set()

    def _count_nack(self, detail: str) -> None:
        """Bump the (recoverable) nack budget; a runaway nack storm still
        indicates something systemically wrong — e.g. a sender that never
        drops its fps — and eventually fails the daemon."""
        with self._lock:
            self._nack_count += 1
            self.nacks_total += 1
            count = self._nack_count
        if count >= self.max_nacks:
            self.error_queue.put(f"receiver exceeded {self.max_nacks} consecutive dedup nacks; last: {detail}")
            self.error_event.set()

    def decode_counters(self) -> dict:
        """Stable-schema decode-path counters (GET /api/v1/profile/decode and
        bench.py's ``decode_counters`` section; docs/datapath-performance.md)."""
        out = dict(DECODE_COUNTER_ZERO)
        with self._stats_lock:
            out.update(self._decode_stats)
            out["decode_events_dropped"] = self._decode_events_dropped
        out["socket_events_dropped"] = self.socket_events_dropped()
        out["decode_workers"] = len(self._decode_threads)
        out["decode_queue_depth"] = self._work_q.qsize()
        out["decode_nacks"] = self.nacks_total
        if self.segment_store is not None:
            out.update(self.segment_store.counters())
        pool = self.processor.bufpool.counters()
        for k in ("pool_hits", "pool_misses", "pool_hit_rate"):
            out[k] = pool[k]
        out.update(self.processor.verify_counters())
        if self.pump is not None:
            # multi-process pump: the decode work happened in the worker
            # processes; merge their pushed snapshots so one scrape shows
            # the whole gateway (the mux-on-the-parent telemetry contract)
            from skyplane_tpu_torch.gateway.pump import merge_numeric_counters

            out = merge_numeric_counters(out, self.pump.decode_snapshots())
        return out

    def socket_events_dropped(self) -> int:
        """Socket profile events lost to the bounded queue (surfaced by
        GET /api/v1/profile/socket/receiver — truncation is never silent)."""
        with self._lock:
            return self._socket_events_dropped

    def _recv_exact(self, conn: socket.socket, n: int) -> bytes:
        inj = get_injector()
        if inj.enabled:
            # docs/fault-injection.md: a mid-payload disconnect at the framing
            # boundary — the partial chunk is dropped (never landed, no ack),
            # and the sender's socket-death path re-queues and resends it
            inj.check("receiver.recv", ConnectionError, "injected mid-payload disconnect")
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = conn.recv_into(view[got:], min(self.recv_block_size, n - got))
            if r == 0:
                raise ConnectionError(f"socket closed mid-payload ({got}/{n} bytes)")
            got += r
        return bytes(buf)
