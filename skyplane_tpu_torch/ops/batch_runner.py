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

With a ``mesh`` (``parallel/datapath_spmd.py``) the runner shards each
window's rows over the mesh's positions (``FusedCDCFP`` mesh mode): every
window pads to ``max_batch``, rounded up to a multiple of the positions, and
rows are not staged at submit. ``SKYPLANE_TPU_SPMD_CHECK=1`` holds every
sharded window against the host recompute before its results leave.

Two-phase completion: ``BatchHandle.ends`` unblocks when call A + host
boundary selection finish, while call B and its readback are still in
flight; ``BatchHandle.fps`` then finalizes the worker's OWN digests from the
batched lanes.

Spans (docs/observability_torch.md): ``batch.window_wait`` around the leader's
window, ``batch.device_wait`` (async) for a worker blocked on a batch another
worker runs; ``FusedCDCFP`` records ``device.stage``, ``fused.dispatch`` and
``fused.readback``. The counter ``window_wait_ns`` times the same interval
as ``batch.window_wait``, always on.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from skyplane_tpu_torch.obs.tracer import get_tracer
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
    worker's thread.

    ``wait_ns`` (the sender's ``device_wait_ns``) is the time this worker
    spent blocked in ``ends()`` and ``fps()`` on a batch that another worker
    runs. A worker that leads its window, or fills it, runs the batch inside
    ``submit``: its window wait (``batch.window_wait``) and the batch's
    dispatch and readback (``fused.dispatch``, ``fused.readback``) are over
    before the handle exists and are not counted here."""

    def __init__(self, entry: _Entry):
        self._entry = entry
        self.wait_ns = 0

    def _wait(self, event: threading.Event) -> None:
        if not event.is_set():
            t0 = time.perf_counter_ns()
            event.wait(timeout=600)
            waited = time.perf_counter_ns() - t0
            self.wait_ns += waited
            tracer = get_tracer()
            if tracer.enabled:
                # async track: many workers wait on one batch concurrently
                tracer.record_span("batch.device_wait", waited, time.time_ns() - waited, cat="device")
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
        gateway_id: Optional[str] = None,
        mesh=None,
    ):
        self.cdc_params = cdc_params
        # names this runner's gateway on its journaled phases, so the first
        # compiles of two daemons in one process (one flight recorder) are
        # told apart; None leaves the field out, as the JAX runner does
        self.gateway_id = gateway_id
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
        self._counters = {
            "batch_windows": 0,
            "batch_rows": 0,
            "batch_padded_rows": 0,
            "spmd_batches": 0,
            "spmd_check_batches": 0,
            "window_wait_ns": 0,  # leaders' window waits: the batch.window_wait spans' interval
        }
        self._stage_failures: Dict[int, int] = {}
        # the first window pays the kernels' lazy build (nvcc at first use)
        # and first launch: journal it as phase.first_compile so the job
        # waterfall can name it (obs/timeline.py)
        self._saw_first_window = False
        self._zero_rows: Dict[int, np.ndarray] = {}  # bucket -> shared read-only zero row
        self._dev_zero_rows: Dict[int, torch.Tensor] = {}  # bucket -> zero row on the device
        # multi-device gateway: run the two calls sharded over the mesh
        # (parallel/datapath_spmd.py) so every card works the data path.
        # Boundary selection is sequential per chunk, so chunks (the batch
        # dim) are the parallel axis. Shard over ALL mesh axes when the
        # device count fits the window; otherwise over the data axis only —
        # never inflate the window by more than 2x.
        self.mesh = mesh
        self.shard_axes = None
        if mesh is not None:
            sizes = dict(mesh.shape)
            n_flat = int(np.prod(list(sizes.values())))
            data_ax = sizes.get("data", n_flat)
            if n_flat <= self.max_batch:
                self.shard_axes = tuple(sizes.keys())
                divisor = n_flat
            elif data_ax <= self.max_batch:
                self.shard_axes = ("data",)
                divisor = data_ax
                log.warning(
                    f"mesh has {n_flat} devices but the batch window is {self.max_batch}: "
                    f"sharding over the data axis only ({data_ax}); raise tpu_batch_chunks to use all devices"
                )
            else:
                self.mesh = None
                divisor = 1
                log.warning(
                    f"mesh axes {sizes} exceed the {self.max_batch}-chunk batch window; running unsharded "
                    f"— raise tpu_batch_chunks to at least the data-axis size to shard the data path"
                )
            if self.max_batch % divisor:
                new_batch = ((self.max_batch + divisor - 1) // divisor) * divisor
                log.warning(f"rounding max_batch {self.max_batch} -> {new_batch} to divide {divisor} mesh shards")
                self.max_batch = new_batch
        self.fused = FusedCDCFP(cdc_params, pool=self.pool, device=device, mesh=self.mesh, shard_axes=self.shard_axes)
        self.device = self.fused.device
        # structural bit-identity assertion for the mesh path: every sharded
        # batch is checked against the host recompute before any result
        # leaves the runner (tests, dry runs, paranoid deployments)
        self._spmd_check = os.environ.get("SKYPLANE_TPU_SPMD_CHECK", "0").strip().lower() in ("1", "on", "true", "yes")
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
        # numeric only: merge_numeric_counters sums these across pump workers
        c["spmd_devices"] = int(np.prod(list(self.mesh.shape.values()))) if self.mesh is not None else 1
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
        # single-device runners upload each row now; a meshed runner's rows go
        # to their positions' devices at the flush, so it stages none
        if self.mesh is None:
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
            tracer = get_tracer()
            args = {"bucket": bucket} if tracer.enabled else None
            with tracer.timed("batch.window_wait", self._count, "window_wait_ns", cat="device", args=args):
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

    def _count(self, key: str, n: int) -> None:
        with self._lock:
            self._counters[key] += n

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
            first_window = not self._saw_first_window
            self._saw_first_window = True
        end_first_compile = None
        if first_window:
            from skyplane_tpu_torch.obs.events import PH_FIRST_COMPILE
            from skyplane_tpu_torch.obs.timeline import phase_begin

            fields = {"gateway": self.gateway_id} if self.gateway_id else {}
            end_first_compile = phase_begin(PH_FIRST_COMPILE, bucket=bucket, rows=len(entries), **fields)
        n_pad_rows = 0
        try:
            rows = [e.arr for e in entries]
            lens = [e.n for e in entries]
            # batch shapes {1, max_batch}: a lone flush runs B=1, others pad.
            # A meshed runner always pads: a batch of 1 cannot split over
            # the mesh's positions
            n_pad_rows = self.max_batch - len(rows) if len(rows) > 1 or self.mesh is not None else 0
            # a meshed runner stages no rows (see submit)
            dev_rows = None if self.mesh is not None else [e.dev if e.dev is not None else e.arr for e in entries]
            if n_pad_rows > 0:
                rows = rows + [self._zero_row(bucket)] * n_pad_rows
                lens = lens + [0] * n_pad_rows
                if dev_rows is not None:
                    dev_rows = dev_rows + [self._dev_zero_row(bucket)] * n_pad_rows
            pending = self.fused.dispatch(rows, lens, dev_rows=dev_rows)
            if self.mesh is not None and self._spmd_check:
                # before any ends leave the runner: a diverging shard fails
                # this window, not a recipe three stages later
                self._check_mesh_identity(entries, pending)
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
            if end_first_compile is not None:
                end_first_compile()
            with self._lock:
                self._in_flight[bucket] -= 1
                self._counters["batch_windows"] += 1
                self._counters["batch_rows"] += len(entries)
                self._counters["batch_padded_rows"] += n_pad_rows
                if self.mesh is not None:
                    self._counters["spmd_batches"] += 1
                self._cond.notify_all()  # deferring leaders: this bucket drained
            for e in entries:
                e.ends_ready.set()
                e.done.set()

    def _check_mesh_identity(self, entries: List[_Entry], pending) -> None:
        """SKYPLANE_TPU_SPMD_CHECK: assert the mesh-sharded batch is
        bit-identical to the host recompute. ``lanes()`` is cached, so the
        eager readback here makes the later phase-2 call free; verified rows
        get ``fps`` set directly, skipping lazy finalize."""
        from skyplane_tpu_torch.ops.cdc import cdc_and_fps_host

        lanes = pending.lanes()
        for i, e in enumerate(entries):
            if pending.fallback[i] is not None:
                continue  # overflow rows already ARE the exact host recompute
            ends = pending.ends_rows[i]
            fps = finalize_row(lanes[i], ends)
            ref_ends, ref_fps = cdc_and_fps_host(e.arr[: e.n], self.cdc_params)
            if not np.array_equal(np.asarray(ends), np.asarray(ref_ends)) or list(fps) != list(ref_fps):
                raise AssertionError(
                    f"SPMD mesh batch diverged from host recompute (bucket {len(e.arr)}, row {i}, n={e.n})"
                )
            e.fps = fps
        with self._lock:
            self._counters["spmd_check_batches"] += 1

    def _release_pooled(self, entries: List[_Entry]) -> None:
        for e in entries:
            if e.pooled:
                self.pool.release(e.arr)
                e.pooled = False
