"""Disk-backed chunk staging + chunk state log.

Reference parity: skyplane/gateway/chunk_store.py:14-109. Chunk payloads
stage as ``<chunk_dir>/<chunk_id>.chunk``; chunk-state transitions are pushed
onto a status queue the daemon API drains (reference: chunk_store.py:72-91).

Sealed-frame cache (docs/datapath-performance.md "Raw-forward fast path"):
a chunk framed once by the codec path can stage its WIRE bytes as
``<chunk_id>.sealed`` plus a ``<chunk_id>.sealed.meta`` header sidecar, so
every later send of the same chunk (blast tree children, pump re-sends)
splices the sealed file kernel-side instead of re-running the codec.
Entries are refcounted: :meth:`sealed_open` hands out a
:class:`SealedFrameRef` borrow per in-flight frame, and GC
(:meth:`sealed_discard`, driven by the daemon's terminal-chunk sweep)
defers the unlink until the last borrow closes — the same
in_progress→terminal discipline the chunk accounting protocol enforces.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from skyplane_tpu_torch.chunk import ChunkRequest, ChunkState
from skyplane_tpu_torch.gateway.gateway_queue import GatewayQueue
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.obs import lockwitness as lockcheck

SEALED_SUFFIX = ".sealed"
SEALED_META_SUFFIX = ".sealed.meta"


class SealedFrameRef:
    """One refcounted borrow of a staged sealed frame: a read-only fd over
    the staged payload plus the header meta needed to rebuild the wire
    header per send. The fd is opened per borrow, so an entry unlinked by GC
    mid-send keeps streaming (POSIX unlink-while-open); ``close()`` is
    idempotent and the LAST close of a discarded entry removes the files."""

    __slots__ = ("chunk_id", "fd", "length", "meta", "_store", "_closed")

    def __init__(self, chunk_id: str, fd: int, length: int, meta: dict, store: "ChunkStore"):
        self.chunk_id = chunk_id
        self.fd = fd
        self.length = length
        self.meta = meta
        self._store = store
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            os.close(self.fd)
        except OSError:
            pass
        self._store._sealed_unref(self.chunk_id)

    # resource-protocol alias (analysis/resources.py "sealed"): release == close
    release = close


class ChunkStore:
    def __init__(self, chunk_dir: str, clean_stale: bool = True):
        self.chunk_dir = Path(chunk_dir)
        self.chunk_dir.mkdir(parents=True, exist_ok=True)
        if clean_stale:
            # daemon-owned stores sweep leftovers from a prior run; pump
            # worker processes (gateway/pump.py) open the SAME directory
            # mid-transfer and must never delete live chunks
            for pattern in ("*.chunk", f"*{SEALED_SUFFIX}", f"*{SEALED_META_SUFFIX}"):
                for stale in self.chunk_dir.glob(pattern):
                    logger.fs.warning(f"removing stale chunk file {stale}")
                    stale.unlink()
        # per-partition inbound queues (reference: chunk_store.py:44-49)
        self.chunk_requests: Dict[str, GatewayQueue] = {}
        # sklint: disable=unbounded-queue-in-gateway -- sole consumer is the daemon main loop draining unconditionally at 20 Hz; a bound would DROP completion records and wedge terminal accounting
        self.chunk_status_queue: "queue.Queue[dict]" = queue.Queue()
        self._lock = lockcheck.wrap(threading.Lock(), "ChunkStore._lock")
        # sealed-frame cache registry: chunk_id -> {refs, doomed, meta}.
        # Pump workers share the DIRECTORY but not this dict; sealed_open
        # falls back to the on-disk meta sidecar for cross-process entries.
        self._sealed: Dict[str, dict] = {}
        # staged-file fds the pump parent passed over the ctrl channel
        # (SCM_RIGHTS): adopted here, popped once at frame time
        self._adopted_fds: Dict[str, int] = {}

    def add_partition(self, partition_id: str, inbound_queue: GatewayQueue) -> None:
        if partition_id in self.chunk_requests:
            raise ValueError(f"partition {partition_id} already registered")
        self.chunk_requests[partition_id] = inbound_queue

    def add_chunk_request(self, chunk_req: ChunkRequest, state: ChunkState = ChunkState.registered) -> None:
        partition = chunk_req.chunk.partition_id
        if partition not in self.chunk_requests:
            raise ValueError(f"unknown partition {partition} (known: {list(self.chunk_requests)})")
        self.log_chunk_state(chunk_req, state)
        self.chunk_requests[partition].put(chunk_req)

    def log_chunk_state(
        self,
        chunk_req: ChunkRequest,
        new_status: ChunkState,
        operator_handle: Optional[str] = None,
        worker_id: Optional[int] = None,
        metadata: Optional[dict] = None,
    ) -> None:
        record = {
            "chunk_id": chunk_req.chunk.chunk_id,
            "partition": chunk_req.chunk.partition_id,
            "state": new_status.to_short_str(),
            "time": time.time(),
            "handle": operator_handle,
            "worker_id": worker_id,
        }
        if metadata:
            record.update(metadata)
        self.chunk_status_queue.put(record)

    def chunk_path(self, chunk_id: str) -> Path:
        return self.chunk_dir / f"{chunk_id}.chunk"

    def remaining_bytes(self) -> int:
        return shutil.disk_usage(self.chunk_dir).free

    # ---- sealed-frame cache (raw-forward fast path) ----

    def sealed_path(self, chunk_id: str) -> Path:
        return self.chunk_dir / f"{chunk_id}{SEALED_SUFFIX}"

    def sealed_meta_path(self, chunk_id: str) -> Path:
        return self.chunk_dir / f"{chunk_id}{SEALED_META_SUFFIX}"

    def seal_frame(self, chunk_id: str, meta: dict, wire: Optional[bytes] = None) -> None:
        """Stage one sealed frame for raw forwarding. ``meta`` carries the
        send-invariant header fields ``{codec, flags, fingerprint,
        raw_data_len, tenant}``; ``wire`` is the sealed payload, or ``None``
        for compress=none passthrough where the staged ``.chunk`` file IS the
        wire payload and only the meta needs caching. Atomic (tmp +
        ``os.replace``) and idempotent — concurrent framers of the same chunk
        race to an identical result, last writer wins."""
        with self._lock:
            if chunk_id in self._sealed:
                return
        record = dict(meta)
        record["payload"] = "chunk" if wire is None else "sealed"
        if wire is not None:
            spath = self.sealed_path(chunk_id)
            tmp = spath.with_suffix(spath.suffix + ".tmp")
            tmp.write_bytes(wire)
            os.replace(tmp, spath)
        mpath = self.sealed_meta_path(chunk_id)
        tmp = mpath.with_suffix(mpath.suffix + ".tmp")
        tmp.write_text(json.dumps(record))
        os.replace(tmp, mpath)
        with self._lock:
            self._sealed.setdefault(chunk_id, {"refs": 0, "doomed": False, "meta": record})

    def sealed_open(self, chunk_id: str) -> Optional[SealedFrameRef]:
        """Borrow the sealed frame for one send (refcounted; release with
        ``close()``). Returns None when the chunk was never sealed, the entry
        is doomed, or the staged file is gone. Entries sealed by ANOTHER
        process over the shared directory (pump workers) are adopted from the
        on-disk meta sidecar."""
        with self._lock:
            ent = self._sealed.get(chunk_id)
            if ent is not None and ent["doomed"]:
                return None
        meta = ent["meta"] if ent is not None else None
        if meta is None:
            try:
                meta = json.loads(self.sealed_meta_path(chunk_id).read_text())
            except (OSError, ValueError):
                return None
        path = self.chunk_path(chunk_id) if meta.get("payload") == "chunk" else self.sealed_path(chunk_id)
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            # staged file swept out from under a stale registry entry
            with self._lock:
                self._sealed.pop(chunk_id, None)
            return None
        try:
            length = os.fstat(fd).st_size
            with self._lock:
                ent = self._sealed.setdefault(chunk_id, {"refs": 0, "doomed": False, "meta": meta})
                doomed = ent["doomed"]
                if not doomed:
                    ent["refs"] += 1
        except OSError:
            os.close(fd)
            return None
        except BaseException:
            os.close(fd)
            raise
        if doomed:
            os.close(fd)
            return None
        return SealedFrameRef(chunk_id, fd, length, meta, self)

    def sealed_open_by_fp(self, fp_hex: str) -> Optional[SealedFrameRef]:
        """Borrow a sealed frame by its content fingerprint instead of its
        chunk id — the dedup fabric's segment route serves peers by
        fingerprint (``GET /api/v1/segment/<fp>``), and a sealed frame whose
        payload hashes to the requested fp is the PR-17 raw path: no decode,
        no recompress, one fd splice. Same borrow/release contract as
        ``sealed_open`` (the caller must ``close()`` the ref on every path)."""
        with self._lock:
            matches = [cid for cid, ent in self._sealed.items() if not ent["doomed"] and ent["meta"].get("fingerprint") == fp_hex]
        for chunk_id in matches:
            ref = self.sealed_open(chunk_id)
            if ref is not None:
                return ref
        return None

    def _sealed_unref(self, chunk_id: str) -> None:
        with self._lock:
            ent = self._sealed.get(chunk_id)
            if ent is None:
                return
            ent["refs"] -= 1
            if ent["doomed"] and ent["refs"] <= 0:
                del self._sealed[chunk_id]
            else:
                return
        self._unlink_sealed(chunk_id)

    def sealed_discard(self, chunk_id: str) -> None:
        """GC one sealed entry as its chunk leaves this gateway (terminal
        sweep). In-flight borrows defer the unlink to the last ``close()`` —
        the raw-forward twin of the PR-15 staged-chunk refcount fix."""
        with self._lock:
            ent = self._sealed.get(chunk_id)
            if ent is not None:
                if ent["refs"] > 0:
                    ent["doomed"] = True
                    return
                del self._sealed[chunk_id]
        self._unlink_sealed(chunk_id)

    def _unlink_sealed(self, chunk_id: str) -> None:
        for path in (self.sealed_path(chunk_id), self.sealed_meta_path(chunk_id)):
            try:
                path.unlink()
            except OSError:
                pass

    def sealed_stats(self) -> dict:
        with self._lock:
            return {
                "sealed_entries": len(self._sealed),
                "sealed_refs": sum(e["refs"] for e in self._sealed.values()),
            }

    # ---- adopted staged-file fds (pump parent -> sender worker) ----

    def adopt_raw_fd(self, chunk_id: str, fd: int) -> None:
        """Adopt a staged-file fd the pump parent opened and passed over the
        ctrl channel (``send_fds``) — ownership MOVES here; the frame built
        from it (or :meth:`take_raw_fd`'s caller) closes it. Holding the
        parent's fd immunizes the worker's raw send against the staged file
        being GC'd between ship and frame time."""
        with self._lock:
            old = self._adopted_fds.pop(chunk_id, None)
            self._adopted_fds[chunk_id] = fd
        if old is not None:
            try:
                os.close(old)
            except OSError:
                pass

    def take_raw_fd(self, chunk_id: str) -> Optional[int]:
        """Pop the adopted fd for this chunk, transferring ownership to the
        caller. Every frame path (raw or codec) must take-and-resolve it so
        re-framed retries never accumulate descriptors."""
        with self._lock:
            return self._adopted_fds.pop(chunk_id, None)
