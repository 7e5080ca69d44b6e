"""Operator framework + concrete data-plane operators.

Reference parity: skyplane/gateway/operators/gateway_operator.py:32-647.
Worker model: each operator spawns ``n_workers`` threads that pull chunk
requests from the input queue, run ``process``, mark chunk state, and push to
the output queue; failures re-queue the chunk, unexpected exceptions stop the
daemon via error_queue/error_event (reference :66-122 semantics).

The sender/receiver pair carries the GPU data path: GatewaySenderOperator
runs DataPathProcessor (CDC + dedup + codec) on an explicit ``device``
(``"cuda"`` by default) and seals with AES-GCM before framing bytes onto the
socket. Control-API calls go through the standard-library client of
``gateway/control_auth.py``, so neither ``requests`` nor ``cryptography`` is
imported unless TLS certificates or E2EE are asked for.

The object-store operators read and write through ``obj_store/``'s
``StorageInterface.create``: ranged reads into the chunk store, and
multipart writes keyed by the daemon's ``upload_id_map``.
"""

from __future__ import annotations

import os
import queue
import socket
import ssl
import threading
import time
import traceback
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import json

import hashlib

from skyplane_tpu_torch.chunk import DEFAULT_TENANT_ID, ChunkFlags, ChunkRequest, ChunkState, Codec, WireProtocolHeader
from skyplane_tpu_torch.exceptions import SkyplaneTpuException
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.gateway.operators.gateway_receiver import ACK_BYTE, NACK_UNRESOLVED, put_drop_oldest
from skyplane_tpu_torch.obs import NOOP_SPAN, get_registry, get_tracer
from skyplane_tpu_torch.gateway.operators.sender_wire import (
    RECONNECT_POLICY,
    EngineCallbacks,
    RawForwardEngine,
    RawFrameSource,
    RawSendError,
    env_int,
    raw_forward_enabled,
    send_vectored,
)
from skyplane_tpu_torch.gateway.chunk_store import ChunkStore
from skyplane_tpu_torch.gateway.control_auth import ControlRequestError
from skyplane_tpu_torch.gateway.crypto import ChunkCipher
from skyplane_tpu_torch.gateway.gateway_queue import GatewayQueue
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
from skyplane_tpu_torch.ops.pipeline import DataPathProcessor
from skyplane_tpu_torch.tenancy.scheduler import RES_CHUNK_SLOTS, RES_WIRE_BYTES
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.utils.retry import RetryPolicy, retry_backoff

#: fair-share token releases retry transient scheduler errors (the
#: sched.release fault point): a dropped release would leak the tenant's
#: tokens until job teardown — cheap, fast retries make release effectively
#: reliable, and a persistent failure still escalates loudly
SCHED_RELEASE_POLICY = RetryPolicy(
    max_attempts=4, initial_backoff=0.01, max_backoff=0.1, jitter=0.5, exception_class=(SkyplaneTpuException,)
)


class BatchPartialFailure(Exception):
    """A windowed batch died mid-flight, but some chunks had ALREADY been
    acked (delivered + fingerprints committed). Carries per-chunk outcomes so
    the worker loop can report the truth: acked chunks complete, the rest
    failed — instead of smearing 'failed' across delivered chunks."""

    def __init__(self, cause: BaseException, results: List[Optional[bool]]):
        super().__init__(str(cause))
        self.cause = cause
        self.results = results


class GatewayOperator:
    """Base operator: thread pool + worker loop (reference :32-122)."""

    log_in_progress = True  # poll-style operators override to avoid log spam

    def __init__(
        self,
        handle: str,
        region: str,
        input_queue: GatewayQueue,
        output_queue: Optional[GatewayQueue],
        error_event: threading.Event,
        error_queue: "queue.Queue[str]",
        chunk_store: ChunkStore,
        n_workers: int = 1,
        gateway_id: Optional[str] = None,
    ):
        self.handle = handle
        self.region = region
        # owning gateway's id: stamped into span args so a merged fleet
        # timeline can regroup spans into per-gateway rows even when several
        # in-process harness gateways share one tracer (docs/observability.md)
        self.gateway_id = gateway_id
        self.input_queue = input_queue
        self.output_queue = output_queue
        self.error_event = error_event
        self.error_queue = error_queue
        self.chunk_store = chunk_store
        self.n_workers = n_workers
        self.workers: List[threading.Thread] = []
        self.exit_flag = threading.Event()
        if input_queue is not None:
            input_queue.register_handle(handle)

    def start_workers(self) -> None:
        for i in range(self.n_workers):
            t = threading.Thread(target=self.worker_loop, args=(i,), name=f"{self.handle}-w{i}", daemon=True)
            t.start()
            self.workers.append(t)

    def stop_workers(self, timeout: float = 5.0) -> None:
        self.exit_flag.set()
        for t in self.workers:
            t.join(timeout=timeout)

    def worker_loop(self, worker_id: int) -> None:
        """One loop serves both per-chunk and windowed operators: the batch
        size is whatever ``_drain_batch`` returns (1 for base operators; the
        sender overrides it to fill a send window)."""
        try:
            self.worker_setup(worker_id)
            while not self.exit_flag.is_set() and not self.error_event.is_set():
                batch = self._drain_batch()
                if not batch:
                    continue
                if self.log_in_progress:
                    for chunk_req in batch:
                        # sklint: disable=resource-leak-on-path -- ownership transfer: when process_batch returns None the batch moved into a streaming pipeline (pipelined sender) whose ack path performs the terminal complete/requeue/failed accounting
                        self.chunk_store.log_chunk_state(chunk_req, ChunkState.in_progress, self.handle, worker_id)
                try:
                    results = self.process_batch(batch, worker_id)
                    if results is None:
                        # streaming operator (pipelined sender): the batch was
                        # handed to an internal pipeline that does its own
                        # completion/requeue/failure accounting as acks land
                        continue
                except BatchPartialFailure as bf:
                    # account the already-delivered chunks truthfully, fail
                    # the rest, then escalate the underlying cause
                    for chunk_req, ok in zip(batch, bf.results):
                        if ok:
                            self.chunk_store.log_chunk_state(chunk_req, ChunkState.complete, self.handle, worker_id)
                            if self.output_queue is not None:
                                self.output_queue.put(chunk_req)
                        else:
                            self.chunk_store.log_chunk_state(chunk_req, ChunkState.failed, self.handle, worker_id)
                    logger.fs.error(f"[{self.handle}:{worker_id}] batch failed mid-flight: {bf.cause}")
                    raise bf.cause
                except Exception as e:  # noqa: BLE001 — per-chunk failure path
                    ids = ",".join(r.chunk.chunk_id for r in batch)
                    logger.fs.error(f"[{self.handle}:{worker_id}] chunk(s) {ids} failed: {e}")
                    for chunk_req in batch:
                        self.chunk_store.log_chunk_state(chunk_req, ChunkState.failed, self.handle, worker_id)
                    raise
                for chunk_req, succeeded in zip(batch, results):
                    if succeeded:
                        self.chunk_store.log_chunk_state(chunk_req, ChunkState.complete, self.handle, worker_id)
                        if self.output_queue is not None:
                            self.output_queue.put(chunk_req)
                    else:
                        # transient / not-ready: silently re-queue for another pass
                        # (reference :104-106; state stays in_progress to avoid log spam
                        # from poll-style operators like WaitReceiver). Returned to THIS
                        # handle only — a plain put on a mux_and queue would duplicate
                        # the chunk to every sibling branch.
                        self.input_queue.put_for_handle(self.handle, chunk_req)
            self.worker_teardown(worker_id)
        except Exception:  # noqa: BLE001 — fatal: stop the daemon
            tb = traceback.format_exc()
            logger.fs.error(f"[{self.handle}:{worker_id}] fatal: {tb}")
            self.error_queue.put(tb)
            self.error_event.set()

    def _drain_batch(self) -> List[ChunkRequest]:
        try:
            return [self.input_queue.pop(self.handle, timeout=0.25)]
        except queue.Empty:
            return []

    def process_batch(self, batch: List[ChunkRequest], worker_id: int) -> List[bool]:
        return [self.process(chunk_req, worker_id) for chunk_req in batch]

    # hooks
    def worker_setup(self, worker_id: int) -> None: ...

    def worker_teardown(self, worker_id: int) -> None: ...

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        raise NotImplementedError


class GatewayWaitReceiverOperator(GatewayOperator):
    """Polls until the receiver has fully landed a chunk file, then forwards
    (reference :125-150; uses an explicit ``.done`` marker instead of size
    polling so partially-written files are never forwarded)."""

    CHECK_INTERVAL = 0.02
    log_in_progress = False

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        chunk_id = chunk_req.chunk.chunk_id
        done_marker = self.chunk_store.chunk_path(chunk_id).with_suffix(".done")
        if done_marker.exists():
            # handed on landed: a relay's senders below time relay.forward from here
            chunk_req.forward_ns = time.perf_counter_ns()
            chunk_req.forward_wall_ns = time.time_ns() if get_tracer().enabled else 0
            chunk_req.forward_handles = set()
            return True
        time.sleep(self.CHECK_INTERVAL)
        return False  # re-queue until the receiver finishes


class GatewayRandomDataGenOperator(GatewayOperator):
    """Synthetic source data for benchmarking (reference :417-454)."""

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        import numpy as np

        n = chunk_req.chunk.chunk_length_bytes
        seed = int(chunk_req.chunk.chunk_id[:8], 16)
        rng = np.random.default_rng(seed)
        # 50% compressible pattern, 50% random — exercises both codec paths
        half = n // 2
        data = rng.integers(0, 256, size=n - half, dtype=np.uint8).tobytes() + bytes(half)
        self.chunk_store.chunk_path(chunk_req.chunk.chunk_id).write_bytes(data)
        return True


class GatewayReadLocalOperator(GatewayOperator):
    """Reads a byte range of a local (POSIX) source file into the chunk store."""

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        chunk = chunk_req.chunk
        offset = chunk.file_offset_bytes or 0
        with open(chunk.src_key, "rb") as f:
            f.seek(offset)
            data = f.read(chunk.chunk_length_bytes)
        if len(data) != chunk.chunk_length_bytes:
            raise IOError(f"short read on {chunk.src_key}: {len(data)} != {chunk.chunk_length_bytes}")
        self.chunk_store.chunk_path(chunk.chunk_id).write_bytes(data)
        return True


class GatewayWriteLocalOperator(GatewayOperator):
    """Writes a received chunk into its destination position in a local file
    (reference WriteLocal is a no-op :457-473; ours actually materializes the
    file so the localhost harness is a full end-to-end data plane).

    Positional writes go through ``os.pwrite`` on a per-destination cached
    fd: workers landing different chunks — different offsets of one file or
    different files entirely — never serialize behind a shared lock (the old
    ``_open_lock`` gated EVERY write on one mutex). The small cache lock only
    guards the fd map itself; opens and pwrites run outside it. Entries are
    refcounted so LRU eviction can never close an fd mid-write."""

    MAX_CACHED_FDS = 256

    def __init__(self, *args, root: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        # sink-local output root (blast fan-out, docs/blast.md): many sink
        # gateways land the SAME dest_key — each re-anchors it under its own
        # root so per-sink outputs stay byte-verifiable side by side
        self.root = root
        self._fd_lock = threading.Lock()
        self._fds: "OrderedDict[str, list]" = OrderedDict()  # dest -> [fd, refcount]

    def _dest_path(self, dest_key: str) -> Path:
        if not self.root:
            return Path(dest_key)
        p = Path(dest_key)
        if p.is_absolute():
            p = p.relative_to(p.anchor)
        return Path(self.root) / p

    def _acquire_fd(self, dest: Path) -> int:
        key = str(dest)
        with self._fd_lock:
            entry = self._fds.get(key)
            if entry is not None:
                entry[1] += 1
                self._fds.move_to_end(key)
                return entry[0]
        dest.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(key, os.O_WRONLY | os.O_CREAT, 0o644)  # sparse-safe positional create
        with self._fd_lock:
            entry = self._fds.setdefault(key, [fd, 0])
            if entry[0] != fd:
                stale = fd  # raced another worker opening the same destination
            else:
                stale = None
                while len(self._fds) > self.MAX_CACHED_FDS:
                    victim = next((k for k, e in self._fds.items() if e[1] == 0 and k != key), None)
                    if victim is None:
                        break  # everything in use: let the map run hot briefly
                    os.close(self._fds.pop(victim)[0])
            entry[1] += 1
        if stale is not None:
            os.close(stale)
        return entry[0]

    def _release_fd(self, dest: Path) -> None:
        with self._fd_lock:
            entry = self._fds.get(str(dest))
            if entry is not None:
                entry[1] -= 1

    def stop_workers(self, timeout: float = 5.0) -> None:
        super().stop_workers(timeout)
        with self._fd_lock:
            fds, self._fds = [e[0] for e in self._fds.values()], OrderedDict()
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        chunk = chunk_req.chunk
        tracer = get_tracer()
        span_args = (
            {"gateway": self.gateway_id, "hop": chunk.hop} if (tracer.enabled and self.gateway_id) else None
        )
        with tracer.span(
            "chunk.write_local", trace_id=chunk.chunk_id, cat="receiver", force=bool(chunk.traced), args=span_args
        ):
            data = self.chunk_store.chunk_path(chunk.chunk_id).read_bytes()
            dest = self._dest_path(chunk.dest_key)
            offset = chunk.file_offset_bytes or 0
            fd = self._acquire_fd(dest)
            try:
                written = 0
                view = memoryview(data)
                while written < len(data):
                    written += os.pwrite(fd, view[written:], offset + written)
            finally:
                self._release_fd(dest)
        return True



class _ObjStoreOperator(GatewayOperator):
    """Shared plumbing for object-store operators: per-worker-thread interface
    instances (cloud SDK clients are not thread-safe across workers)."""

    def __init__(self, *args, bucket_name: str, bucket_region: str, **kwargs):
        super().__init__(*args, **kwargs)
        self.bucket_name = bucket_name
        self.bucket_region = bucket_region
        self._iface_local = threading.local()

    def _iface(self):
        if not hasattr(self._iface_local, "iface"):
            from skyplane_tpu_torch.obj_store.storage_interface import StorageInterface

            self._iface_local.iface = StorageInterface.create(self.bucket_region, self.bucket_name)
        return self._iface_local.iface


class GatewayObjStoreReadOperator(_ObjStoreOperator):
    """Ranged object-store download into the chunk store (reference :511-589)."""

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        chunk = chunk_req.chunk
        fpath = self.chunk_store.chunk_path(chunk.chunk_id)
        md5 = retry_backoff(
            lambda: self._iface().download_object(
                chunk.src_key, fpath, offset_bytes=chunk.file_offset_bytes, size_bytes=chunk.chunk_length_bytes, generate_md5=True
            ),
            max_retries=4,
        )
        chunk.md5_hash = md5
        return True


class GatewayObjStoreWriteOperator(_ObjStoreOperator):
    """Multipart-aware object-store upload (reference :592-647)."""

    UPLOAD_ID_WAIT_S = 300.0  # how long a part may wait for its upload-id map

    def __init__(self, *args, upload_id_map: Dict[str, str], **kwargs):
        super().__init__(*args, **kwargs)
        self.upload_id_map = upload_id_map  # dest_key -> upload_id (client-pushed)
        self._upload_id_first_wait: Dict[str, float] = {}  # chunk_id -> first requeue ts
        self._wait_lock = threading.Lock()

    def process(self, chunk_req: ChunkRequest, worker_id: int) -> bool:
        chunk = chunk_req.chunk
        fpath = self.chunk_store.chunk_path(chunk.chunk_id)
        dest_key = (chunk.dest_keys or {}).get(self.bucket_region, chunk.dest_key)
        upload_id = self.upload_id_map.get(dest_key) if chunk.multi_part else None
        if chunk.multi_part and upload_id is None:
            # the client's upload-id map push raced this chunk (or failed). A
            # whole-object put_object of one part here would be silently
            # overwritten by the later complete_multipart_upload — corrupting
            # the object while existence-only checks still pass. Re-queue
            # until the map arrives, with a deadline: a map that never arrives
            # (client died mid-dispatch) must fail the transfer loudly.
            now = time.time()
            with self._wait_lock:
                first = self._upload_id_first_wait.setdefault(chunk.chunk_id, now)
            if now - first > self.UPLOAD_ID_WAIT_S:
                raise SkyplaneTpuException(
                    f"no upload_id for multipart {dest_key} after {self.UPLOAD_ID_WAIT_S:.0f}s "
                    "(client upload-id map push lost?)"
                )
            logger.fs.warning(f"[{self.handle}] no upload_id yet for multipart {dest_key}; re-queueing")
            time.sleep(0.1)
            return False
        with self._wait_lock:
            self._upload_id_first_wait.pop(chunk.chunk_id, None)
        retry_backoff(
            lambda: self._iface().upload_object(
                fpath,
                dest_key,
                part_number=chunk.part_number,
                upload_id=upload_id,
                check_md5=chunk.md5_hash,
                mime_type=chunk.mime_type,
            ),
            max_retries=4,
        )
        return True

class _WindowFpView:
    """Dedup-index view for the in-flight frames of one socket.

    Fingerprints whose literals were framed EARLIER ON THE SAME SOCKET (but
    not yet acked) are REF-safe for later chunks on that socket: the receiver
    stores literals in frame order before resolving later refs (dedup.py
    consistency contract). The view is discarded if the stream fails, so
    nothing uncommitted ever leaks into the durable index.

    Serial mode allocates a fresh ``pending`` set per window; the pipelined
    engine passes each stream's persistent pending set, extending the same
    REF-safety across every frame in flight on that stream.
    """

    def __init__(self, index: SenderDedupIndex, pending: Optional[set] = None):
        self.index = index
        self.pending: set = pending if pending is not None else set()

    def __contains__(self, fp: bytes) -> bool:
        return fp in self.pending or fp in self.index


class _WindowStats:
    """Per-window profile event carrier for the pipelined sender: frames of
    one `_drain_batch` window share this object, and the event (same schema
    as the serial path's per-window event) is emitted when the LAST frame of
    the window resolves — acked, re-queued, or failed."""

    __slots__ = ("op", "worker_id", "n_chunks", "t0", "lock", "n_done", "n_acked", "wire_bytes")

    def __init__(self, op: "GatewaySenderOperator", worker_id: int, n_chunks: int):
        self.op = op
        self.worker_id = worker_id
        self.n_chunks = n_chunks
        self.t0 = time.perf_counter()
        self.lock = threading.Lock()
        self.n_done = 0
        self.n_acked = 0
        self.wire_bytes = 0

    def add_wire(self, n: int) -> None:
        with self.lock:
            self.wire_bytes += n

    def note(self, acked: bool) -> None:
        with self.lock:
            self.n_done += 1
            if acked:
                self.n_acked += 1
            done = self.n_done >= self.n_chunks
            if not done:
                return
            seconds = time.perf_counter() - self.t0
            event = {
                "handle": self.op.handle,
                "worker_id": self.worker_id,
                "target": self.op.target_gateway_id,
                "n_chunks": self.n_chunks,
                "n_acked": self.n_acked,
                "wire_bytes": self.wire_bytes,
                "seconds": round(seconds, 6),
                "pipelined": True,
            }
        self.op.note_window_event(event, seconds)


class _SenderEngineOps(EngineCallbacks):
    """Chunk/index accounting for one worker's wire engine — the reaper-side
    half of what the serial worker loop did inline: commit-after-delivery,
    NACK fingerprint rollback, silent re-queue of transient failures, and
    daemon-fatal escalation."""

    def __init__(self, op: "GatewaySenderOperator", worker_id: int):
        self.op = op
        self.worker_id = worker_id

    def on_delivered(self, frame) -> None:
        op = self.op
        tenant = frame.req.chunk.tenant_id or DEFAULT_TENANT_ID
        if op.dedup_index is not None:
            # the ack means the chunk (and its dedup literals) is durably
            # landed, so these commits are truthful (commit-after-delivery);
            # the tenant tag attributes the index bytes on persistent indexes
            for fp, size in frame.new_fps:
                op.dedup_index.add(fp, size, tenant=tenant)
        op.chunk_store.log_chunk_state(frame.req, ChunkState.complete, op.handle, self.worker_id)
        if op.output_queue is not None:
            op.output_queue.put(frame.req)
        if op.tenant_registry is not None:
            op.tenant_registry.note_delivered(tenant, frame.req.chunk.chunk_length_bytes)
        op.sched_release(frame.req)
        if frame.window is not None:
            frame.window.note(acked=True)

    def on_nack(self, frame) -> None:
        op = self.op
        if op.dedup_index is not None:
            # receiver no longer holds a segment this recipe REF'd: forget
            # exactly those fps (the engine clears them from the stream's
            # pending view) so the re-queued retry resends literals
            for fp in frame.ref_fps:
                op.dedup_index.discard(fp)
        logger.fs.warning(
            f"[{op.handle}:{self.worker_id}] receiver nacked chunk {frame.req.chunk.chunk_id}; "
            f"dropped {len(frame.ref_fps)} fps, will resend literals"
        )

    def on_requeue(self, frame) -> None:
        # transient (socket death / NACK retry): back to THIS handle's queue,
        # state stays in_progress — the serial path's silent-requeue contract.
        # Scheduler tokens release NOW; the retry pass re-acquires them (a
        # NACK-storming tenant burns its own tokens on every round trip).
        op = self.op
        op.sched_release(frame.req)
        if frame.counted_retry:
            # per-chunk retry budget: a poisoned chunk (every resend NACKs or
            # kills its socket) must fail the job with a precise error, not
            # cycle the queue forever. Shutdown requeues are not counted.
            retries = getattr(frame.req, "wire_retries", 0) + 1
            frame.req.wire_retries = retries
            if retries > op.chunk_retry_budget:
                msg = (
                    f"chunk {frame.req.chunk.chunk_id} exhausted its retry budget "
                    f"({retries - 1} resends to {op.target_gateway_id} all failed; "
                    f"budget SKYPLANE_TPU_CHUNK_RETRY_BUDGET={op.chunk_retry_budget})"
                )
                logger.fs.error(f"[{op.handle}:{self.worker_id}] {msg}")
                op.chunk_store.log_chunk_state(frame.req, ChunkState.failed, op.handle, self.worker_id)
                if frame.window is not None:
                    frame.window.note(acked=False)
                op.error_queue.put(msg)
                op.error_event.set()
                return
        op.input_queue.put_for_handle(op.handle, frame.req)
        if frame.window is not None:
            frame.window.note(acked=False)

    def on_failed(self, frame) -> None:
        self.op.sched_release(frame.req)
        self.op.chunk_store.log_chunk_state(frame.req, ChunkState.failed, self.op.handle, self.worker_id)
        if frame.window is not None:
            frame.window.note(acked=False)

    def on_fatal(self, msg: str) -> None:
        logger.fs.error(f"[{self.op.handle}:{self.worker_id}] {msg}")
        self.op.error_queue.put(msg)
        self.op.error_event.set()

    def on_wire_sent(self, nbytes: int) -> None:
        # per-edge egress attribution: the engine reports frame bytes as they
        # hit the socket; the operator keys them by its current target
        self.op.note_egress(nbytes)


class GatewaySenderOperator(GatewayOperator):
    """Pushes chunks to a remote gateway over framed TCP(+TLS).

    Default mode is the pipelined wire engine (operators/sender_wire.py):
    each worker keeps a continuous stream flowing — the worker thread frames
    (file read + DataPathProcessor + seal) into a bounded frame-ahead queue,
    a socket pump streams frames back-to-back under a byte-bounded in-flight
    window with NO drain at window boundaries, and an ack reaper commits
    fingerprints as the frame-ordered acks land concurrently with ongoing
    sends. When the in-flight window stays full and acks lag, the engine
    stripes up to ``SKYPLANE_TPU_SENDER_STREAMS`` extra connections.

    ``SKYPLANE_TPU_SENDER_PIPELINED=0`` selects the legacy serial wire loop
    (drain a window, stream its frames, then block collecting acks — one
    full pipeline drain per window); the exactness suites compare the two
    byte-for-byte. The reference streams with no app-level ack at all
    (chunk.py:96-155 n_chunks_left); we keep the ack for the dedup
    commit-after-delivery contract and pipeline around it instead.

    The payload runs through DataPathProcessor (codec + dedup) and optional
    AES-GCM seal.
    """

    def __init__(
        self,
        *args,
        target_gateway_id: str,
        target_host: str,
        target_control_port: int,
        codec_name: str = "none",
        dedup: bool = False,
        cdc_params: CDCParams = CDCParams(),
        e2ee_key: Optional[bytes] = None,
        use_tls: bool = True,
        batch_runner=None,
        window: int = 16,
        window_bytes: int = 256 << 20,
        api_token: Optional[str] = None,
        control_tls: bool = False,
        source_gateway_id: Optional[str] = None,
        pipelined: Optional[bool] = None,
        max_streams: Optional[int] = None,
        frame_ahead: Optional[int] = None,
        dedup_index: Optional[SenderDedupIndex] = None,
        scheduler=None,
        tenant_registry=None,
        peer_serve: bool = False,
        raw_forward: Optional[bool] = None,
        device="cuda",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.target_gateway_id = target_gateway_id
        self.target_host = target_host
        self.target_control_port = target_control_port
        self.use_tls = use_tls
        # raw config retained for the multi-process pump (gateway/pump.py):
        # worker processes rebuild the framing stack from these
        self._codec_name = codec_name
        self._e2ee_key = e2ee_key
        self.cdc_params = cdc_params
        from skyplane_tpu_torch.ops.pipeline import effective_codec_name

        # the device is explicit (the JAX package's processor finds jax's
        # default backend); a batch runner on another device raises
        self.processor = DataPathProcessor(
            codec_name=effective_codec_name(codec_name, device),
            dedup=dedup,
            cdc_params=cdc_params,
            batch_runner=batch_runner,
            device=device,
        )
        # a daemon-shared (persistent, cross-job) index when injected; an
        # ephemeral per-operator one otherwise (docs/multitenancy.md)
        self.dedup_index = dedup_index if dedup_index is not None else (SenderDedupIndex() if dedup else None)
        # fair-share gate (tenancy/scheduler.py): chunks acquire per-tenant
        # wire-byte and chunk-slot tokens before framing, released as their
        # frames resolve — None disables gating (single-tenant/bare tests)
        self.scheduler = scheduler
        self.tenant_registry = tenant_registry
        self.source_gateway_id = source_gateway_id
        self.cipher = ChunkCipher(e2ee_key) if e2ee_key else None
        self.window = max(1, int(window))
        self.window_bytes = int(window_bytes)
        self.control_tls = control_tls
        self.api_token = api_token
        # per-window send profile events (drained by /profile/socket/sender,
        # the sender-side analog of the receiver's socket profiler). Bounded:
        # with nothing polling the endpoint, a long-lived daemon must not
        # accumulate one dict per window forever — drops are COUNTED
        # (profile_events_dropped in wire_counters), never silent
        self.socket_profile_events: "queue.Queue[dict]" = queue.Queue(maxsize=4096)
        self._events_dropped = 0
        self._events_dropped_lock = threading.Lock()
        self._window_hist = get_registry().histogram(
            "sender_window_seconds", help_="wall time of one sender send window (submit batch)"
        )
        self._local = threading.local()
        # pipelined wire engine config (operators/sender_wire.py); env knobs
        # documented in docs/configuration.md. Constructor args override for
        # tests and the serial-vs-pipelined exactness suites.
        if pipelined is None:
            pipelined = os.environ.get("SKYPLANE_TPU_SENDER_PIPELINED", "1").strip().lower() not in ("0", "false", "off")
        self.pipelined = bool(pipelined)
        if max_streams is None:
            try:
                extra = int(os.environ.get("SKYPLANE_TPU_SENDER_STREAMS", "2"))
            except ValueError:
                logger.fs.warning("ignoring malformed SKYPLANE_TPU_SENDER_STREAMS; using 2")
                extra = 2
            max_streams = 1 + max(0, extra)
        self.max_streams = max(1, int(max_streams))
        if frame_ahead is None:
            try:
                frame_ahead = int(os.environ.get("SKYPLANE_TPU_SENDER_FRAME_AHEAD", "2"))
            except ValueError:
                logger.fs.warning("ignoring malformed SKYPLANE_TPU_SENDER_FRAME_AHEAD; using 2")
                frame_ahead = 2
        self.frame_ahead = max(1, int(frame_ahead))
        # recovery budgets (docs/fault-injection.md): a chunk that keeps
        # failing (NACK cycles, repeated socket death mid-frame) must fail the
        # job with a precise error instead of re-queueing forever; the serial
        # path shares the wire engine's consecutive-reset budget
        self.chunk_retry_budget = env_int("SKYPLANE_TPU_CHUNK_RETRY_BUDGET", 32)
        self.reset_budget = env_int("SKYPLANE_TPU_STREAM_RESET_BUDGET", 5)
        self._engines: list = []  # every worker's live engine (wire_counters aggregation)
        self._engines_lock = threading.Lock()
        # applied-replan cutover (docs/provisioning.md "Repair & drain"):
        # bumped by retarget(); serial-path workers compare their cached
        # socket's generation against it and re-dial the (new) target
        self._target_gen = 0
        # blast peer-serve (docs/blast.md): this sender runs on a destination
        # gateway re-serving landed chunks to a sibling sink; arms the
        # relay.peer_serve fault point (drop -> silent requeue -> re-serve)
        self.peer_serve = bool(peer_serve)
        # raw-forward fast path (docs/datapath-performance.md): splice
        # already-sealed staged files kernel-side instead of re-framing.
        # Constructor False (or planner raw_eligible=False) disables for this
        # edge; the SKYPLANE_TPU_RAW_FORWARD knob master-gates everything.
        self.raw_forward = (raw_forward if raw_forward is not None else True) and raw_forward_enabled()
        self._dedup = bool(dedup)
        # passthrough eligibility: wire bytes == staged chunk bytes exactly
        # (identity codec, no recipe, no seal) — only then can the payload
        # skip userspace entirely; the header's blake2b fingerprint is
        # computed once and cached as sealed meta
        self._raw_passthrough = (
            self.processor.codec.codec_id == Codec.NONE and not self._dedup and self.cipher is None
        )
        # one stateless raw engine serves the serial path (pipelined workers
        # use their wire engine's); serial raw counters merge in wire_counters
        self._raw_serial = RawForwardEngine()
        self._serial_raw_lock = threading.Lock()
        self._serial_raw = {"wire_raw_frames": 0, "wire_raw_bytes": 0, "wire_raw_fallbacks": 0}
        # per-(src,dst)-edge egress bytes, keyed by target gateway id at the
        # moment the bytes hit the socket (retargets start a new key) — the
        # counter-measured source of skyplane_egress_bytes_total{src,dst}
        self._egress_lock = threading.Lock()
        self._egress_bytes: Dict[str, int] = {}
        # the first data-socket dial (port negotiation + connect + TLS
        # handshake) is journaled as phase.pool_warm for the job waterfall
        # (obs/timeline.py); flag race between workers is benign — duplicate
        # phases merge into one envelope in the timeline builder
        self._pool_warm_recorded = False
        from skyplane_tpu_torch.gateway.control_auth import control_session

        self._session = control_session(api_token)

    @property
    def _control_base(self) -> str:
        scheme = "https" if self.control_tls else "http"
        return f"{scheme}://{self.target_host}:{self.target_control_port}/api/v1"

    def _frame_span_args(self, req: ChunkRequest) -> dict:
        """Span args for this sender's wire spans: gateway id + overlay hop
        index (0 at the original source, +1 per relay) — the identity a
        merged fleet timeline regroups and orders process rows by. Called
        only on TRACED chunks, so the per-call dict never taxes the
        tracing-off path."""
        return {"gateway": self.source_gateway_id or self.gateway_id, "hop": req.chunk.hop or 0}

    def _make_socket(self) -> socket.socket:
        end_warm = None
        if not self._pool_warm_recorded:
            self._pool_warm_recorded = True
            from skyplane_tpu_torch.obs.events import PH_POOL_WARM
            from skyplane_tpu_torch.obs.timeline import phase_begin

            end_warm = phase_begin(
                PH_POOL_WARM,
                gateway=self.source_gateway_id or self.gateway_id,
                target=self.target_gateway_id,
            )
        try:
            # ask the remote gateway for an ephemeral data port (reference
            # :225-246), identifying this source so the sink can count
            # distinct sources
            resp = self._session.post(
                f"{self._control_base}/servers",
                json={"source_gateway_id": self.source_gateway_id} if self.source_gateway_id else None,
                timeout=30,
            )
            resp.raise_for_status()
            info = resp.json()
            port = info["server_port"]
            self._apply_dedup_budget(info)
            sock = socket.create_connection((self.target_host, port), timeout=30)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self.use_tls:
                    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE  # self-signed receiver certs
                    sock = ctx.wrap_socket(sock)
            except BaseException:
                # a failed TLS handshake (or setsockopt on a dying connection)
                # must not strand the TCP socket: retarget()/redial loops call
                # this repeatedly and would bleed one fd per failed attempt
                sock.close()
                raise
            self._local.port = port
            return sock
        finally:
            if end_warm is not None:
                end_warm()

    def _apply_dedup_budget(self, server_info: dict) -> None:
        """Split the sink's advertised segment-store capacity fairly across
        the distinct source gateways it has seen: k senders each believing
        16 GiB resident against a 36 GiB sink would REF segments the sink
        already evicted. Half the fair share leaves headroom for sources the
        sink has not met yet and for eviction-order skew; re-applied on every
        /servers call so late-joining sources shrink existing budgets."""
        if self.dedup_index is None:
            return
        capacity = server_info.get("dedup_capacity_bytes")
        if not capacity:
            return
        n_sources = max(1, int(server_info.get("n_sources", 1)))
        self.dedup_index.set_max_bytes(max(1 << 20, capacity // (2 * n_sources)))

    def _sock(self) -> socket.socket:
        if getattr(self._local, "sock_gen", None) != self._target_gen:
            # the operator was retargeted since this worker last dialed: the
            # cached socket points at the OLD next hop — drop and re-dial
            self._reset_sock()
            self._local.sock_gen = self._target_gen
        if getattr(self._local, "sock", None) is None:
            self._local.sock = self._make_socket()
        return self._local.sock

    def _reset_sock(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._local.sock = None

    def worker_teardown(self, worker_id: int) -> None:
        engine = getattr(self._local, "engine", None)
        if engine is not None:
            engine.close(drain_timeout_s=2.0)
            self._local.engine = None
        self._reset_sock()

    def _engine(self, worker_id: int):
        """This worker's pipelined wire engine (created on first use; one per
        worker so frames stay ordered per framer)."""
        engine = getattr(self._local, "engine", None)
        if engine is None:
            from skyplane_tpu_torch.gateway.operators.sender_wire import SenderWireEngine

            engine = SenderWireEngine(
                self._make_socket,
                _SenderEngineOps(self, worker_id),
                inflight_limit_bytes=self.window_bytes,
                frame_ahead=self.frame_ahead,
                max_streams=self.max_streams,
                name=f"{self.handle}-w{worker_id}",
                abort_check=lambda: self.exit_flag.is_set() or self.error_event.is_set(),
                gateway_id=self.source_gateway_id or self.gateway_id,
            )
            self._local.engine = engine
            with self._engines_lock:
                self._engines.append(engine)
        return engine

    def retarget(self, new_target_gateway_id: str, host: str, control_port: int, dedup_index=None) -> int:
        """Applied replan (docs/provisioning.md "Repair & drain"): point this
        sender at a new next-hop gateway mid-job. Future connects dial the new
        target (``_make_socket`` reads the fields per call); every live wire
        stream is flagged for a pump-thread cutover reset, so un-acked frames
        re-queue and re-frame onto the new route exactly like a stream break
        while acked chunks stay truthfully complete. A dedup sender swaps to
        the new target's index (``dedup_index``, or a fresh ephemeral one) —
        REFs against the OLD sink's segments would NACK-storm the new one.
        An ack from the old hop racing the swap can seed the new index with
        an unproven fp; that heals through the NACK → literal-resend path,
        never corruption. Returns 1 (operators retargeted)."""
        logger.fs.warning(
            f"[{self.handle}] retarget: {self.target_gateway_id} -> {new_target_gateway_id} "
            f"({host}:{control_port})"
        )
        self.target_gateway_id = new_target_gateway_id
        self.target_host = host
        self.target_control_port = int(control_port)
        if self.dedup_index is not None:
            self.dedup_index = dedup_index if dedup_index is not None else SenderDedupIndex()
        self._target_gen += 1  # serial-path workers re-dial on next use
        with self._engines_lock:
            engines = list(self._engines)
        for engine in engines:
            engine.retarget()
        return 1

    def sched_acquire(self, req: ChunkRequest) -> bool:
        """Block until this chunk's fair-share tokens are granted (wire bytes
        sized by the chunk, one chunk slot covering its share of batch-runner
        occupancy). False = daemon shutting down; caller re-queues."""
        if self.scheduler is None:
            return True
        tenant = req.chunk.tenant_id or DEFAULT_TENANT_ID
        abort = lambda: self.exit_flag.is_set() or self.error_event.is_set()  # noqa: E731
        if not self.scheduler.acquire(tenant, RES_CHUNK_SLOTS, 1, abort_check=abort):
            return False
        try:
            granted = self.scheduler.acquire(tenant, RES_WIRE_BYTES, req.chunk.chunk_length_bytes, abort_check=abort)
        except BaseException:
            # SchedulerTimeout (or an abort raced with the grant) on the wire
            # tokens must hand back the chunk slot: it is this tenant's OWN
            # budget, and nothing downstream knows a slot was taken
            SCHED_RELEASE_POLICY.call(lambda: self.scheduler.release(tenant, RES_CHUNK_SLOTS, 1), log_errors=False)
            raise
        if not granted:
            SCHED_RELEASE_POLICY.call(lambda: self.scheduler.release(tenant, RES_CHUNK_SLOTS, 1), log_errors=False)
            return False
        return True

    def sched_release(self, req: ChunkRequest) -> None:
        """Return one chunk's tokens (its frame resolved: ack/requeue/fail).
        Releases retry transient failures (SCHED_RELEASE_POLICY): a silently
        dropped release would leak this tenant's tokens — starving its OWN
        later chunks — until job teardown."""
        if self.scheduler is None:
            return
        tenant = req.chunk.tenant_id or DEFAULT_TENANT_ID
        SCHED_RELEASE_POLICY.call(
            lambda: self.scheduler.release(tenant, RES_WIRE_BYTES, req.chunk.chunk_length_bytes), log_errors=False
        )
        SCHED_RELEASE_POLICY.call(lambda: self.scheduler.release(tenant, RES_CHUNK_SLOTS, 1), log_errors=False)

    def note_egress(self, nbytes: int) -> None:
        """Account wire bytes against the CURRENT target edge (called from
        the serial send loop and the engine's on_wire_sent callback)."""
        if nbytes <= 0:
            return
        target = self.target_gateway_id
        with self._egress_lock:
            self._egress_bytes[target] = self._egress_bytes.get(target, 0) + nbytes

    def egress_by_edge(self) -> Dict[str, int]:
        """{target_gateway_id: wire bytes sent} — the daemon aggregates this
        into skyplane_egress_bytes_total{src=<this gateway>,dst=<target>}."""
        with self._egress_lock:
            return dict(self._egress_bytes)

    def note_window_event(self, event: dict, seconds: float) -> None:
        """Emit one per-window profile event (bounded queue, counted drops)
        and feed the unified-registry window-latency histogram."""
        if put_drop_oldest(self.socket_profile_events, event):
            with self._events_dropped_lock:
                self._events_dropped += 1
        self._window_hist.observe(seconds)

    def datapath_counters(self) -> dict:
        """This operator's DataPathProcessor counters — the daemon's
        /profile/compression aggregation point. The multi-process pump
        operator overrides this to merge its worker processes' stats."""
        return self.processor.stats.as_dict()

    def wire_counters(self) -> dict:
        """Stable-schema sender wire counters summed across worker engines
        (GET /api/v1/profile/socket/sender and bench.py's wire section)."""
        from skyplane_tpu_torch.gateway.operators.sender_wire import SENDER_WIRE_COUNTER_ZERO

        out = dict(SENDER_WIRE_COUNTER_ZERO)
        with self._engines_lock:
            engines = list(self._engines)
        for engine in engines:
            counters = engine.counters()
            for k in out:
                out[k] += counters.get(k, 0)
        with self._serial_raw_lock:
            for k, v in self._serial_raw.items():
                out[k] += v
        with self._events_dropped_lock:
            out["profile_events_dropped"] += self._events_dropped
        return out

    def _drain_batch(self) -> List[ChunkRequest]:
        """One blocking pop, then opportunistically fill the window — bounded
        by chunk count AND total staged bytes, so a window of default-sized
        64 MiB chunks cannot multiply per-worker memory by the window size."""
        try:
            batch = [self.input_queue.pop(self.handle, timeout=0.25)]
        except queue.Empty:
            return []
        total = batch[0].chunk.chunk_length_bytes
        while len(batch) < self.window and total < self.window_bytes:
            try:
                req = self.input_queue.get_nowait(self.handle)
            except queue.Empty:
                break
            batch.append(req)
            total += req.chunk.chunk_length_bytes
        self._admit(batch)
        return batch

    def _admit(self, batch: List[ChunkRequest]) -> None:
        """Count each dequeued request's wait since the POST that registered
        it (``admit_wait_ns``) once in this operator: a request requeued
        after a NACK, a dead socket or a shutdown comes back as the same
        object, and multicast branches share it, so the request keeps the
        handles that counted it. A traced chunk records the wait as its
        ``chunk.admit`` span, the parent of this worker's ``wire.frame``.

        On a relay the request also carries its receive operator's hand-off
        stamp: the wait since then counts the same way (``forward_wait_ns``,
        ``forward_chunks``), as the ``relay.forward`` span under
        ``chunk.admit``."""
        tracer = get_tracer()
        if tracer.enabled:
            self._local.admit_spans = {}
        now = time.perf_counter_ns()
        stats = self.processor.stats
        for req in batch:
            cid = req.chunk.chunk_id
            traced = tracer.enabled and (req.chunk.traced or tracer.sampled(cid))
            admit_span = None
            counted = req.admit_handles
            # None: not registered by this daemon's POST (pump worker); the
            # handle already in it: a requeue
            if counted is not None and self.handle not in counted:
                counted.add(self.handle)  # one handle per operator; set.add is atomic
                wait = now - req.admit_ns
                stats.add("admit_wait_ns", wait)
                if req.admit_wall_ns and traced:
                    admit_span = self._local.admit_spans[cid] = tracer.record_span(
                        "chunk.admit", wait, req.admit_wall_ns, trace_id=cid, cat="sender", force=True,
                        args=self._frame_span_args(req),
                    )
            forwarded = req.forward_handles
            if forwarded is not None and self.handle not in forwarded:
                forwarded.add(self.handle)
                wait = now - req.forward_ns
                stats.add("forward_wait_ns", wait)
                stats.add("forward_chunks", 1)
                if req.forward_wall_ns and traced:
                    tracer.record_span(
                        "relay.forward", wait, req.forward_wall_ns, trace_id=cid, cat="relay", force=True,
                        args=self._frame_span_args(req), parent=admit_span,
                    )

    def _header_from_meta(self, chunk, meta: dict, length: int, n_left: int) -> WireProtocolHeader:
        """Rebuild the per-send wire header from cached send-invariant meta
        (relay ``.hdr`` sidecars and sealed-frame cache entries share the
        field schema); only data_len and n_chunks_left vary per send."""
        return WireProtocolHeader(
            chunk_id=chunk.chunk_id,
            data_len=length,
            raw_data_len=meta["raw_data_len"],
            codec=meta["codec"],
            flags=meta["flags"],
            fingerprint=meta["fingerprint"],
            n_chunks_left_on_socket=n_left,
            tenant_id=meta.get("tenant") or DEFAULT_TENANT_ID,
        )

    def _raw_frame_chunk(self, chunk_req: ChunkRequest, n_left: int):
        """Raw-forward eligibility (docs/datapath-performance.md): build
        ``(RawFrameSource, header, relay)`` when this chunk's wire bytes
        already exist as a staged file and need no re-framing — else None and
        the codec path decides. The ladder, most- to least-sealed:

          (a) relay re-send — a ``.hdr`` sidecar means the staged bytes ARE
              the wire payload (any codec/dedup/cipher: they're opaque here);
          (b) sealed-frame cache — this chunk was framed once by the codec
              path and its wire bytes staged (dedup off: recipes depend on
              per-edge index state and are never cacheable);
          (c) compress=none passthrough — wire bytes == chunk file bytes;
              the blake2b fingerprint the receiver verifies is computed once
              (streamed, no full materialization) and sealed as meta.

        Every failure degrades silently to the codec path — eligibility is
        an optimization decision, never a correctness gate."""
        if not self.raw_forward:
            return None
        chunk = chunk_req.chunk
        store = self.chunk_store
        fpath = store.chunk_path(chunk.chunk_id)
        hdr_sidecar = fpath.with_suffix(".hdr")
        if hdr_sidecar.exists():
            try:
                meta = json.loads(hdr_sidecar.read_text())
            except (OSError, ValueError):
                return None  # sidecar raced GC: let the codec path decide
            fd = store.take_raw_fd(chunk.chunk_id)
            if fd is None:
                try:
                    fd = os.open(fpath, os.O_RDONLY)
                except OSError:
                    return None
            try:
                length = os.fstat(fd).st_size
                header = self._header_from_meta(chunk, meta, length, n_left)
            except Exception:
                os.close(fd)
                return None  # torn sidecar/stat: the codec path decides
            except BaseException:
                os.close(fd)
                raise
            return RawFrameSource(fd, length), header, True
        if self._dedup:
            return None
        ref = store.sealed_open(chunk.chunk_id)
        if ref is not None:
            try:
                chunk.fingerprint = ref.meta["fingerprint"]
                header = self._header_from_meta(chunk, ref.meta, ref.length, n_left)
            except BaseException:
                ref.close()
                raise
            return RawFrameSource(ref.fd, ref.length, release_fn=ref.close), header, False
        if not self._raw_passthrough:
            return None
        try:
            fd = os.open(fpath, os.O_RDONLY)
        except OSError:
            return None
        try:
            length = os.fstat(fd).st_size
            h = hashlib.blake2b(digest_size=16)
            off = 0
            while off < length:
                b = os.pread(fd, min(1 << 20, length - off), off)
                if not b:
                    raise OSError(f"staged chunk truncated at {off}/{length}")
                h.update(b)
                off += len(b)
            meta = {
                "codec": int(Codec.NONE),
                "flags": 0,
                "fingerprint": h.hexdigest(),
                "raw_data_len": length,
                "tenant": chunk.tenant_id or DEFAULT_TENANT_ID,
            }
            # meta-only seal: the .chunk file stays the payload; siblings
            # (blast tree children, pump re-sends) skip even the one hash pass
            try:
                store.seal_frame(chunk.chunk_id, meta)
            except OSError as e:
                logger.fs.warning(f"[{self.handle}] sealed-meta staging failed for {chunk.chunk_id}: {e}")
            chunk.fingerprint = meta["fingerprint"]
            header = self._header_from_meta(chunk, meta, length, n_left)
        except OSError:
            os.close(fd)
            return None
        except BaseException:
            os.close(fd)
            raise
        return RawFrameSource(fd, length), header, False

    def _maybe_seal(self, chunk, payload, wire: bytes, header: WireProtocolHeader) -> None:
        """Stage this codec-framed chunk's wire bytes for raw re-serves.
        Gated on peer_serve: sealing costs one disk write per chunk and only
        pays when the SAME chunk frames again (N blast tree children) — a
        plain source edge frames each chunk exactly once."""
        if not (self.raw_forward and self.peer_serve) or self._dedup or payload is None or payload.is_recipe:
            return
        meta = {
            "codec": header.codec,
            # TRACED is a per-send sampling decision, never cached
            "flags": header.flags & ~int(ChunkFlags.TRACED),
            "fingerprint": header.fingerprint,
            "raw_data_len": header.raw_data_len,
            "tenant": header.tenant_id,
        }
        try:
            self.chunk_store.seal_frame(chunk.chunk_id, meta, None if self._raw_passthrough else wire)
        except OSError as e:
            logger.fs.warning(f"[{self.handle}] sealed-frame staging failed for {chunk.chunk_id}: {e}")

    def _bump_serial_raw(self, key: str, n: int = 1) -> None:
        with self._serial_raw_lock:
            self._serial_raw[key] += n

    def _frame_chunk(self, chunk_req: ChunkRequest, view: Optional[_WindowFpView], n_left: int):
        """Build (payload, wire, header) for one chunk. payload is None on the
        relay path (opaque staged bytes re-framed with their original header).
        Times the codec path's stages into the processor's stats
        (``read_ns``, ``encode_ns``, ``seal_ns``) and, for a chunk the framer
        traces, records them as the spans ``chunk.read``, ``datapath.encode``
        and ``wire.seal``."""
        chunk = chunk_req.chunk
        # a staged-file fd the pump parent passed for raw forwarding that the
        # raw path did not consume (ineligible/disabled): close it here so
        # codec-path re-frames never accumulate descriptors
        adopted = self.chunk_store.take_raw_fd(chunk.chunk_id)
        if adopted is not None:
            try:
                os.close(adopted)
            except OSError:
                pass
        fpath = self.chunk_store.chunk_path(chunk.chunk_id)
        hdr_sidecar = fpath.with_suffix(".hdr")
        if hdr_sidecar.exists():
            meta = json.loads(hdr_sidecar.read_text())
            wire = fpath.read_bytes()
            return None, wire, WireProtocolHeader(
                chunk_id=chunk.chunk_id,
                data_len=len(wire),
                raw_data_len=meta["raw_data_len"],
                codec=meta["codec"],
                flags=meta["flags"],
                fingerprint=meta["fingerprint"],
                n_chunks_left_on_socket=n_left,
                tenant_id=meta.get("tenant", DEFAULT_TENANT_ID),
            )
        # each stage inside the chunk's wire.frame, traced on the framer's decision
        tracer, add = get_tracer(), self.processor.stats.add
        cid, force = chunk.chunk_id, bool(chunk.traced)
        with tracer.timed("chunk.read", add, "read_ns", trace_id=cid, cat="sender", force=force):
            data = fpath.read_bytes()
        with tracer.timed("datapath.encode", add, "encode_ns", trace_id=cid, cat="sender", force=force):
            payload = self.processor.process(data, view if view is not None else self.dedup_index)
        if view is not None:
            # later chunks in this window may REF these (in-order socket)
            view.pending.update(fp for fp, _ in payload.new_fingerprints)
        with tracer.timed("wire.seal", add, "seal_ns", trace_id=cid, cat="sender", force=force):
            wire = payload.wire_bytes
            if self.cipher is not None:
                wire = self.cipher.seal(wire)
            chunk.fingerprint = payload.fingerprint
            header = chunk.to_wire_header(
                n_chunks_left_on_socket=n_left,
                wire_length=len(wire),
                raw_wire_length=payload.raw_len,
                codec=payload.codec,
                is_compressed=payload.is_compressed,
                is_encrypted=self.cipher is not None,
                is_recipe=payload.is_recipe,
            )
            self._maybe_seal(chunk, payload, wire, header)
        return payload, wire, header

    def _register_batch(self, batch: List[ChunkRequest]) -> None:
        # pre-register the whole window at the destination in ONE control POST
        # (reference pre-registers per chunk, :277-319). Must precede the data
        # frames so completion accounting never sees an unregistered chunk.
        tracer = get_tracer()
        if tracer.enabled:
            # same deterministic decision the framer will make: rides the
            # registration so destination operators trace the same chunks.
            # OR-preserve: on a relay the UPSTREAM sender's decision already
            # arrived with the chunk request — overwriting it with a local
            # re-sample would break multi-hop stitching when hop gateways run
            # different (or zero) sample rates
            for req in batch:
                req.chunk.traced = bool(req.chunk.traced) or tracer.sampled(req.chunk.chunk_id)
        regs = []
        for req in batch:
            d = req.as_dict()
            # the registration describes the chunk AT THE NEXT HOP: its hop
            # index advances by one, so each gateway's spans carry their
            # position on the overlay path (docs/observability.md)
            d["chunk"]["hop"] = (req.chunk.hop or 0) + 1
            regs.append(d)

        def _post_registration() -> None:
            resp = self._session.post(f"{self._control_base}/chunk_requests", json=regs, timeout=30)
            resp.raise_for_status()

        # jittered + deadline-bounded (utils/retry.py): every sender worker
        # pre-registers its window, so a control-API blip hits many workers at
        # once — flat sleeps would march them back in lockstep
        retry_backoff(
            _post_registration,
            max_retries=3,
            initial_backoff=0.5,
            max_backoff=4.0,
            jitter=0.5,
            deadline_s=90.0,
            exception_class=(ControlRequestError,),
        )

    def process_batch(self, batch: List[ChunkRequest], worker_id: int) -> Optional[List[bool]]:
        gen0 = self._target_gen
        self._register_batch(batch)
        if not self.pipelined:
            results = self._process_batch_serial(batch, worker_id)
            self._reregister_if_retargeted(batch, gen0)
            return results
        # pipelined path: hand the window to this worker's wire engine. The
        # submit loop below IS the framer stage — it runs the data path and
        # blocks only on the frame-ahead queue, so by the time the last chunk
        # is framed the first ones are already on the wire (and possibly
        # acked). Completion/requeue/failure accounting happens in the
        # engine's reaper as acks land; worker_loop sees None and moves
        # straight to the next _drain_batch with no inter-window drain.
        engine = self._engine(worker_id)
        engine.note_window()
        window = _WindowStats(self, worker_id, len(batch))
        inj = get_injector()
        for req in batch:
            if self.peer_serve and inj.enabled and inj.fire("relay.peer_serve"):
                # injected drop of a peer-served chunk (docs/fault-injection
                # .md relay.peer_serve): silent requeue — the chunk re-serves
                # on a later pass, exactly like a transient stream break
                self.input_queue.put_for_handle(self.handle, req)
                window.note(acked=False)
                continue
            # fair-share gate BEFORE framing: a tenant over its share parks
            # HERE (its tokens return as its own acks land), so its backlog
            # never occupies frame-ahead buffers or batch-runner windows that
            # other tenants' chunks could be using
            # sklint: disable=resource-leak-on-path -- ownership transfer: the granted tokens ride the frame submitted to the engine below; sched_release fires from the engine's ack/requeue/reaper paths once the frame resolves
            if not self.sched_acquire(req):
                # shutdown: silent-requeue contract, tokens never granted
                self.input_queue.put_for_handle(self.handle, req)
                window.note(acked=False)
                continue
            # wire bytes counted on the frame the engine actually enqueued
            # (a saturation-striped chunk is re-framed; counting inside the
            # frame builder would double it)
            frame = engine.submit(lambda pending, _req=req: self._build_wire_frame(_req, pending, window))
            window.add_wire(frame.wire_len)
        self._reregister_if_retargeted(batch, gen0)
        return None

    def _reregister_if_retargeted(self, batch: List[ChunkRequest], gen0: int) -> None:
        """Close the replan-cutover registration race: this batch was
        pre-registered at the target read at batch START; a retarget landing
        between that POST and the frames going out means some frames ship to
        the NEW target carrying ids only the OLD target knows — staged bytes
        the new receiver's completion accounting would never adopt. When the
        target generation moved during the batch, re-register the whole batch
        at the CURRENT target (idempotent at the gateway; a chunk whose data
        ends up arriving via the old route still completes there — every
        route converges on the same sinks)."""
        if self._target_gen == gen0:
            return
        try:
            self._register_batch(batch)
        except ControlRequestError as e:
            # frames that raced the cutover will requeue through their stream
            # reset and re-register on the retry pass; log, don't fail
            logger.fs.warning(f"[{self.handle}] post-cutover re-registration failed: {e}")

    def _build_wire_frame(self, req: ChunkRequest, pending_fps: set, window: "_WindowStats"):
        """Framer body: one chunk -> WireFrame, REF decisions against the
        target stream's in-flight pending view (engine-chosen)."""
        from skyplane_tpu_torch.gateway.operators.sender_wire import WireFrame

        view = _WindowFpView(self.dedup_index, pending=pending_fps) if self.dedup_index is not None else None
        tracer = get_tracer()
        # chunk.traced covers the relay case: the upstream sender's sampling
        # decision rides the pre-registration, so a relay whose local rate
        # would miss this id still records its hop of the path
        traced = tracer.enabled and (bool(req.chunk.traced) or tracer.sampled(req.chunk.chunk_id))
        span = self._frame_span(req) if traced else NOOP_SPAN
        # n_left=0: the reference-compat window countdown has no meaning on a
        # continuous stream (receivers ignore it; docs/wire_protocol.md) —
        # the one header field where serial and pipelined frames differ
        with span:
            frame_span = tracer.current_span_id()  # handed to the pump and reaper threads
            raw = self._raw_frame_chunk(req, n_left=0)
            if raw is not None:
                # raw-forward: the staged file IS the wire payload; the pump
                # thread splices it kernel-side (or materializes it on a
                # raw-disabled stream — byte-identical either way)
                source, header, relay = raw
                if traced and not relay:
                    header.flags |= ChunkFlags.TRACED
                frame = WireFrame(req, header, b"", relay=relay, window=window, traced=traced, raw=source)
                frame.span_parent = frame_span
                return frame
            payload, wire, header = self._frame_chunk(req, view, n_left=0)
        if traced and payload is not None:
            # stamp the sampling decision into the wire header so the
            # receiver's spans for this chunk record regardless of its local
            # rate — sender and receiver stitch into one timeline. Relay
            # frames keep their original header (opaque re-framed bytes).
            header.flags |= ChunkFlags.TRACED
        frame = WireFrame(
            req,
            header,
            wire,
            new_fps=payload.new_fingerprints if payload is not None else (),
            ref_fps=payload.ref_fingerprints if payload is not None else (),
            relay=payload is None,
            window=window,
            traced=traced,
        )
        frame.span_parent = frame_span
        return frame

    def _frame_span(self, req: ChunkRequest):
        """A traced chunk's ``wire.frame`` span, child of the ``chunk.admit``
        this worker recorded when it dequeued the chunk."""
        admitted = getattr(self._local, "admit_spans", None) or {}
        return get_tracer().span(
            "wire.frame",
            trace_id=req.chunk.chunk_id,
            cat="sender",
            force=True,
            args=self._frame_span_args(req),
            parent=admitted.get(req.chunk.chunk_id),
        )

    def _process_batch_serial(self, batch: List[ChunkRequest], worker_id: int) -> List[bool]:
        view = _WindowFpView(self.dedup_index) if self.dedup_index is not None else None
        results = [False] * len(batch)
        sent = []  # (req, payload) for acked-frame bookkeeping only
        acquired: List[ChunkRequest] = []  # fair-share tokens held this window
        window_wire = 0
        t_window = time.perf_counter()
        try:
            sock = self._sock()
            # frame-and-stream: each chunk's wire bytes are released as soon
            # as they hit the socket, so worker memory holds ONE chunk at a
            # time (plus ack bookkeeping), not the whole window
            tracer = get_tracer()
            inj = get_injector()
            for i, req in enumerate(batch):
                if self.peer_serve and inj.enabled and inj.fire("relay.peer_serve"):
                    continue  # injected peer-serve drop: result stays False -> requeue
                if not self.sched_acquire(req):
                    break  # shutdown mid-window: un-sent chunks re-queue below
                acquired.append(req)
                traced = tracer.enabled and (bool(req.chunk.traced) or tracer.sampled(req.chunk.chunk_id))
                span = self._frame_span(req) if traced else NOOP_SPAN
                raw = None
                payload = wire = None
                with span:
                    frame_span = tracer.current_span_id()
                    # serial raw-forward: per-worker eligibility mirrors the
                    # engine's per-stream raw_ok — one raw-send error flips
                    # this worker to the codec path for its lifetime
                    if getattr(self._local, "raw_ok", True):
                        raw = self._raw_frame_chunk(req, n_left=len(batch) - i - 1)
                    if raw is None:
                        payload, wire, header = self._frame_chunk(req, view, n_left=len(batch) - i - 1)
                if raw is not None:
                    source, header, relay = raw
                    if traced and not relay:
                        header.flags |= ChunkFlags.TRACED
                elif traced and payload is not None:
                    header.flags |= ChunkFlags.TRACED  # receiver spans follow the sender's sample
                send_span = (
                    tracer.span(
                        "wire.send",
                        trace_id=req.chunk.chunk_id,
                        cat="sender",
                        force=True,
                        args=self._frame_span_args(req),
                        parent=frame_span,
                    )
                    if traced
                    else NOOP_SPAN
                )
                with send_span:
                    if raw is not None:
                        try:
                            self._raw_serial.send(sock, header.to_bytes(), source)
                        except RawSendError:
                            # mid-stream fallback, serial flavor: the frame
                            # may be torn mid-payload, so fall through to the
                            # socket-error handler (reset + requeue unacked)
                            # with raw disabled for this worker from now on
                            self._local.raw_ok = False
                            self._bump_serial_raw("wire_raw_fallbacks")
                            raise
                        finally:
                            source.release()
                        self._bump_serial_raw("wire_raw_frames")
                        self._bump_serial_raw("wire_raw_bytes", source.length)
                        sent_len = source.length
                    else:
                        # vectored codec send: header as the iovec prefix,
                        # one sendmsg, no concatenation copy
                        send_vectored(sock, header.to_bytes(), wire)
                        sent_len = len(wire)
                window_wire += sent_len
                self.note_egress(sent_len)
                del wire
                if payload is not None:
                    # only the fingerprint lists are needed for ack
                    # bookkeeping — keeping wire_bytes alive in `sent` would
                    # pin up to window_bytes per worker until acks complete
                    payload.wire_bytes = b""
                # carry the BATCH index: a peer-serve drop skips mid-batch,
                # so enumerate(sent) would misattribute later acks
                sent.append((i, req, payload))
            # cumulative ack collection: acks arrive in frame order (the
            # receiver's per-connection loop is sequential). sendall only
            # proves bytes reached the local TCP buffer; the ack means the
            # chunk (and its dedup literals) is durably landed, so the
            # fingerprint commits below are truthful.
            for i, req, payload in sent:
                ack = sock.recv(1)
                if ack == ACK_BYTE:
                    if self.dedup_index is not None and payload is not None:
                        for fp, size in payload.new_fingerprints:
                            self.dedup_index.add(fp, size, tenant=req.chunk.tenant_id or DEFAULT_TENANT_ID)
                    if self.tenant_registry is not None:
                        self.tenant_registry.note_delivered(
                            req.chunk.tenant_id or DEFAULT_TENANT_ID, req.chunk.chunk_length_bytes
                        )
                    results[i] = True
                elif ack == NACK_UNRESOLVED:
                    if self.dedup_index is not None and payload is not None:
                        # receiver no longer holds a segment this recipe
                        # REF'd: forget those fps (durable index AND window
                        # view) so the retry resends literals
                        for fp in payload.ref_fingerprints:
                            self.dedup_index.discard(fp)
                            if view is not None:
                                view.pending.discard(fp)
                        logger.fs.warning(
                            f"[{self.handle}:{worker_id}] receiver nacked chunk {req.chunk.chunk_id}; "
                            f"dropped {len(payload.ref_fingerprints)} fps, will resend literals"
                        )
                    else:
                        # relay path: the staged bytes are opaque — we CANNOT
                        # rebuild the recipe, and re-queueing would replay the
                        # identical unresolvable frame forever. Fail fast,
                        # carrying the outcomes of chunks already acked.
                        raise BatchPartialFailure(
                            SkyplaneTpuException(
                                f"downstream receiver nacked relayed chunk {req.chunk.chunk_id} "
                                "(unresolvable dedup ref; relay cannot rebuild the recipe)"
                            ),
                            results,
                        )
                else:
                    raise OSError(f"bad/missing chunk ack ({ack!r})")
            self._local.consec_sock_errors = 0  # a fully-resolved window proves the path healthy
        except (OSError, ssl.SSLError, ControlRequestError) as e:
            # un-acked chunks stay False and are re-queued by the caller;
            # nothing uncommitted leaked into the dedup index (window view)
            logger.fs.warning(f"[{self.handle}:{worker_id}] socket error mid-window: {e}")
            self._reset_sock()
            # serial twin of the wire engine's circuit breaker: jittered
            # reconnect pacing, and past the consecutive-window budget the
            # job fails loudly — with already-acked chunks accounted
            # truthfully. A window that delivered ANY ack before dying proves
            # the path still works (the engine's ack-resets-the-counter
            # semantics): a flaky-but-progressing link must keep progressing,
            # not hard-fail after reset_budget windows.
            errors = 1 if any(results) else getattr(self._local, "consec_sock_errors", 0) + 1
            self._local.consec_sock_errors = errors
            if errors >= self.reset_budget:
                raise BatchPartialFailure(
                    OSError(
                        f"sender socket to {self.target_gateway_id} failed {errors} consecutive "
                        f"windows (budget SKYPLANE_TPU_STREAM_RESET_BUDGET={self.reset_budget}): {e}"
                    ),
                    results,
                )
            time.sleep(RECONNECT_POLICY.backoff_s(errors - 1))
        finally:
            # every frame in this window resolved (acked, failed, or about to
            # be re-queued by the caller): the fair-share tokens come back —
            # including on the BatchPartialFailure escalation path
            for req in acquired:
                self.sched_release(req)
        seconds = time.perf_counter() - t_window
        event = {
            "handle": self.handle,
            "worker_id": worker_id,
            "target": self.target_gateway_id,
            "n_chunks": len(batch),
            "n_acked": sum(results),
            "wire_bytes": window_wire,
            "seconds": round(seconds, 6),
        }
        self.note_window_event(event, seconds)
        return results
