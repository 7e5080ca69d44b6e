"""Micro-batching of CDC + fingerprint device work across gateway workers.

A gateway runs 16-32 sender workers, each processing one chunk at a time.
Per-chunk device calls would waste launches and run undersized grids, so
this runner groups concurrent same-bucket submissions into one [B, bucket]
batch for ``FusedCDCFP``, with bounded latency: small transfers never wait
for a full batch.

Leader-based protocol (no dedicated thread): the first worker to open a
window waits ``max_wait_ms`` for peers on a ``threading.Condition``, then
runs the batch for everyone. A full window flushes at once. While a previous
batch of the same bucket is still executing the leader keeps its window
open (device work is FIFO, so flushing earlier would not start it sooner),
up to a hard ceiling.

Batch shapes are B in {1, max_batch}: a lone flush runs B=1, anything else
is padded to max_batch with zero rows (n=0). Padded host buffers come from a
shared ``BufferPool`` and are recycled right after the dispatch, since each
row's bytes were uploaded synchronously at submit (``FusedCDCFP.stage``).

Two-phase completion: ``BatchHandle.ends`` unblocks when call A + host
boundary selection finish, while call B and its readback are still in
flight; ``BatchHandle.fps`` then finalizes the worker's OWN digests from the
batched lanes.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from skyplane_tpu_torch.ops.bufpool import BufferPool, bucket_size
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.fused_cdc import FusedCDCFP, finalize_row

log = logging.getLogger(__name__)


@dataclass(eq=False)  # identity semantics: membership tests compare entries by identity
class _Entry:
    arr: np.ndarray  # padded to the bucket size
    n: int  # true length
    pooled: bool = False  # arr came from the runner's BufferPool (recycle after dispatch)
    dev: object = None  # row staged on the device at submit
    ends_ready: threading.Event = field(default_factory=threading.Event)  # phase 1
    done: threading.Event = field(default_factory=threading.Event)  # phase 2
    ends: Optional[np.ndarray] = None
    lanes: Optional[np.ndarray] = None  # [n_slots, 8] lanes (finalized lazily)
    fps: Optional[List[bytes]] = None  # set directly for overflow-fallback rows
    error: Optional[BaseException] = None


class BatchHandle:
    """Per-submission two-phase result. ``ends()`` unblocks when boundary
    selection lands; ``fps()`` finalizes this row's digests in the calling
    worker's thread. ``wait_ns`` accumulates the time spent blocked."""

    def __init__(self, entry: _Entry):
        self._entry = entry
        self.wait_ns = 0

    def _wait(self, event: threading.Event) -> None:
        if not event.is_set():
            t0 = time.perf_counter_ns()
            event.wait(timeout=600)
            self.wait_ns += time.perf_counter_ns() - t0
        if not event.is_set():
            raise TimeoutError("device batch runner stalled")
        if self._entry.error is not None:
            raise self._entry.error

    def ends(self) -> np.ndarray:
        self._wait(self._entry.ends_ready)
        return self._entry.ends

    def fps(self) -> List[bytes]:
        e = self._entry
        self._wait(e.done)
        if e.fps is None:
            e.fps = finalize_row(e.lanes, e.ends)
            e.lanes = None
        return e.fps


class DeviceBatchRunner:
    def __init__(
        self,
        cdc_params: CDCParams = CDCParams(),
        max_batch: int = 8,
        max_wait_ms: float = 3.0,
        pool: Optional[BufferPool] = None,
        device="cuda",
    ):
        self.cdc_params = cdc_params
        self.max_batch = max_batch
        if not math.isfinite(max_wait_ms) or max_wait_ms < 0:  # NaN/inf/negative would stall the leader
            max_wait_ms = 3.0
        self.max_wait_s = min(max_wait_ms, 5000.0) / 1000.0
        # ceiling on the leader's deferral while a previous batch runs: a
        # wedged batch must surface as TimeoutError, not defer forever
        self.defer_ceiling_s = max(100.0 * self.max_wait_s, 120.0)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._open: Dict[int, List[_Entry]] = {}  # bucket -> entries of the open window
        self._in_flight: Dict[int, int] = {}  # bucket -> batches executing
        self.pool = pool if pool is not None else BufferPool()
        self._counters = {"batch_windows": 0, "batch_rows": 0, "batch_padded_rows": 0, "spmd_batches": 0, "spmd_check_batches": 0}
        self._stage_failures: Dict[int, int] = {}
        self._zero_rows: Dict[int, np.ndarray] = {}  # bucket -> shared read-only zero row
        self._dev_zero_rows: Dict[int, torch.Tensor] = {}  # bucket -> zero row on the device
        self.fused = FusedCDCFP(cdc_params, pool=self.pool, device=device)
        self.device = self.fused.device

    def _note_stage_failure(self, bucket: int, err: BaseException) -> None:
        """Log the first staging failure per bucket; count the rest."""
        with self._lock:
            n = self._stage_failures.get(bucket, 0)
            self._stage_failures[bucket] = n + 1
        if n == 0:
            log.warning(
                "device staging failed for bucket %d (%r); affected rows upload at flush instead "
                "(further occurrences are counted, not logged)", bucket, err,
            )

    def counters(self) -> dict:
        """Hot-path counters, merged into DataPathStats.as_dict() (same keys as the JAX runner)."""
        with self._lock:
            c = dict(self._counters)
            c["stage_failures"] = sum(self._stage_failures.values())
        cap = c["batch_windows"] * self.max_batch
        c["batch_occupancy"] = round(c["batch_rows"] / cap, 4) if cap else 0.0
        c["spmd_devices"] = 1
        c.update(self.pool.counters())
        c.update(self.fused.counters())
        return c

    # ---- public API ----

    def submit(self, arr: np.ndarray, padded: Optional[np.ndarray] = None) -> BatchHandle:
        """Join the current window for this chunk's bucket; returns a two-phase
        handle. Without ``padded`` the runner pads ``arr`` into a pooled
        buffer and recycles it itself; a caller's padded buffer is left alone."""
        pooled = padded is None
        if pooled:
            n = len(arr)
            padded = self.pool.acquire(bucket_size(n))
            padded[:n] = arr
            padded[n:] = 0
        entry = _Entry(arr=padded, n=len(arr), pooled=pooled)
        try:
            entry.dev = self.fused.stage(padded)
        except Exception as err:  # noqa: BLE001 — the flush uploads this row instead
            entry.dev = None
            self._note_stage_failure(len(padded), err)
        bucket = len(padded)
        with self._lock:
            group = self._open.setdefault(bucket, [])
            group.append(entry)
            leader = len(group) == 1
            if len(group) >= self.max_batch:
                self._open[bucket] = []
                to_run = group
                self._cond.notify_all()  # a deferring leader's window just flushed
            else:
                to_run = None
        if to_run is not None:
            self._run_batch(to_run)
        elif leader:
            to_run, ceiling_flush = self._lead_window(entry, bucket)
            if to_run is not None:
                if ceiling_flush:
                    # the previous batch blew the ceiling and may be wedged: run
                    # on a helper so this leader reaches its own TimeoutError
                    threading.Thread(target=self._run_batch, args=(to_run,), name="batch-ceiling-flush", daemon=True).start()
                else:
                    self._run_batch(to_run)
        return BatchHandle(entry)

    def _lead_window(self, entry: _Entry, bucket: int):
        """Wait max_wait for peers (longer while this bucket's previous batch
        runs, up to the ceiling); returns (entries to run or None, ceiling_flush)."""
        deadline = time.monotonic() + self.max_wait_s
        hard_deadline = deadline + self.defer_ceiling_s
        with self._cond:
            while True:
                group_now = self._open.get(bucket, [])
                if not any(e is entry for e in group_now):
                    return None, False  # a full flush already took this window
                now = time.monotonic()
                busy = self._in_flight.get(bucket, 0) > 0
                if now >= deadline and (not busy or now >= hard_deadline):
                    self._open[bucket] = []
                    return group_now, busy and now >= hard_deadline
                remaining = (deadline - now) if now < deadline else (hard_deadline - now)
                self._cond.wait(timeout=max(remaining, 0.001))

    def cdc_and_fps(self, arr: np.ndarray, padded: Optional[np.ndarray] = None) -> Tuple[np.ndarray, List[bytes]]:
        """Blocking single-phase form: (segment ends, 16-byte fingerprints)."""
        handle = self.submit(arr, padded)
        return handle.ends(), handle.fps()

    # ---- batch execution (leader) ----

    def _zero_row(self, bucket: int) -> np.ndarray:
        row = self._zero_rows.get(bucket)
        if row is None:
            row = np.zeros(bucket, np.uint8)
            row.setflags(write=False)
            with self._lock:
                row = self._zero_rows.setdefault(bucket, row)
        return row

    def _dev_zero_row(self, bucket: int) -> torch.Tensor:
        row = self._dev_zero_rows.get(bucket)
        if row is None:
            row = torch.zeros(bucket, dtype=torch.uint8, device=self.device)
            with self._lock:
                row = self._dev_zero_rows.setdefault(bucket, row)
        return row

    def _run_batch(self, entries: List[_Entry]) -> None:
        bucket = len(entries[0].arr)
        with self._lock:
            self._in_flight[bucket] = self._in_flight.get(bucket, 0) + 1
        n_pad_rows = 0
        try:
            rows = [e.arr for e in entries]
            lens = [e.n for e in entries]
            dev_rows = [e.dev if e.dev is not None else e.arr for e in entries]
            # batch shapes {1, max_batch}: a lone flush runs B=1, others pad
            n_pad_rows = self.max_batch - len(rows) if len(rows) > 1 else 0
            if n_pad_rows > 0:
                rows = rows + [self._zero_row(bucket)] * n_pad_rows
                lens = lens + [0] * n_pad_rows
                dev_rows = dev_rows + [self._dev_zero_row(bucket)] * n_pad_rows
            pending = self.fused.dispatch(rows, lens, dev_rows=dev_rows)
            # phase 1: ends are final, call B is enqueued
            for e, ends, fb in zip(entries, pending.ends_rows, pending.fallback):
                if fb is not None:
                    e.ends, e.fps = fb  # overflow row: exact host recompute
                else:
                    e.ends = ends
                e.ends_ready.set()
            self._release_pooled(entries)  # rows are on the card (or recomputed)
            lanes = pending.lanes()  # phase 2: blocking fingerprint readback
            for i, e in enumerate(entries):
                if e.fps is None:
                    e.lanes = lanes[i]
        except BaseException as err:  # noqa: BLE001 — every waiter must wake
            for e in entries:
                e.error = err
            self._release_pooled(entries)
        finally:
            with self._lock:
                self._in_flight[bucket] -= 1
                self._counters["batch_windows"] += 1
                self._counters["batch_rows"] += len(entries)
                self._counters["batch_padded_rows"] += n_pad_rows
                self._cond.notify_all()  # deferring leaders: this bucket drained
            for e in entries:
                e.ends_ready.set()
                e.done.set()

    def _release_pooled(self, entries: List[_Entry]) -> None:
        for e in entries:
            if e.pooled:
                self.pool.release(e.arr)
                e.pooled = False
