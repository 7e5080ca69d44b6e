"""Batched CDC + segment-fingerprint device steps with small readbacks.

Two device calls per batch of padded same-bucket rows, as in the JAX
package (greedy min/max boundary selection between them is sequential and
runs on the host):

  call A:  K-AB gear_compact (gear hash, candidate test and ordered
           compaction in one pass) -> packed [B, cap+1] int32, read back
           (blocking, a few KiB)
  host:    select_boundaries over the sparse candidate positions
  call B:  K-C segment_fp over the uploaded [B, n_slots] end offsets
           -> [B, n_slots, 8] lanes, read back at ``PendingBatch.lanes()``

The batch is uploaded once and stays on the card across both calls. On CUDA
every launch of a driver goes to its own stream; call B's end offsets go up
through a pinned buffer and its lanes come back into a pinned buffer with
``non_blocking`` copies, and a CUDA event recorded after the readback tells
``lanes()`` when they have landed. ``dispatch`` therefore returns as soon as
call B is enqueued, with the segment ends already final. On the CPU the same
functions run their plain PyTorch versions, synchronously.

Overflow contract: a row whose true candidate count exceeds the compaction
capacity (about 8x the expected density) is recomputed exactly on the host,
so results are bit-exact against the host path for all inputs.

The JAX package's HBM donation has no counterpart here (PyTorch's caching
allocator reuses the batch's memory once the stream is done with it); the
``donated_batches`` counter stays 0 so the stats key schema is unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.cdc import CDCParams, select_boundaries
from skyplane_tpu_torch.ops.fingerprint import digests_from_lanes
from skyplane_tpu_torch.state import DeviceTables, device_tables


def candidate_cap(bucket: int, params: CDCParams = CDCParams()) -> int:
    """Static candidate-compaction capacity: 8x the expected density of one
    candidate per ``avg_bytes``."""
    return max(64, 8 * (bucket // params.avg_bytes))


def slots_cap(bucket: int, params: CDCParams) -> int:
    """Static fingerprint slot count: every segment is >= min_bytes except at
    most one tail piece, plus one garbage slot for bucket padding."""
    return bucket // params.min_bytes + 2


def _candidates_impl(batch: torch.Tensor, lens: torch.Tensor, tables: DeviceTables, *, mask_bits: int, cap: int):
    """Call A: [B, bucket] uint8 + lens [B] int32 -> [B, cap+1] int32: the first
    ``cap`` candidate positions (ascending, sentinel-padded) and the true count."""
    return kernels.gear_compact(batch, lens, tables, mask_bits, cap)


def _fp_impl(batch: torch.Tensor, ends_slots: torch.Tensor, tables: DeviceTables) -> torch.Tensor:
    """Call B: [B, bucket] uint8 + [B, n_slots] int32 ends -> [B, n_slots, 8] int32 lanes."""
    return kernels.segment_fp(batch, ends_slots, tables)


def _host_exact(arr: np.ndarray, params: CDCParams) -> Tuple[np.ndarray, List[bytes]]:
    """Exact host recompute for overflow rows (pathological candidate density)."""
    from skyplane_tpu_torch.ops.cdc import cdc_segment_ends
    from skyplane_tpu_torch.ops.fingerprint import segment_fingerprints_host_batch

    ends = cdc_segment_ends(arr, params)
    return ends, segment_fingerprints_host_batch(arr, ends)


def finalize_row(lanes_row: np.ndarray, ends: np.ndarray) -> List[bytes]:
    """[n_slots, 8] uint32 lanes of one row -> its 16-byte segment digests."""
    return digests_from_lanes(lanes_row[: len(ends)], ends)


class PendingBatch:
    """Phase split of one batched call: segment ends are final at
    construction (call A + host selection done, call B enqueued); ``lanes()``
    blocks on the fingerprint readback. Rows that overflowed the candidate
    cap carry their complete exact result in ``fallback`` instead."""

    def __init__(self, fused: "FusedCDCFP", b: int, ends_rows, fallback, lanes_host, event, ends_scratch, keep):
        self._fused = fused
        self.b = b
        self.ends_rows = ends_rows  # per-row np ends, None for fallback rows
        self.fallback = fallback  # per-row (ends, digests) or None
        self._lanes_host = lanes_host  # [B, n_slots, 8] int32 (pinned on CUDA)
        self._event = event  # recorded after the readback copy; None on the CPU
        self._ends_scratch = ends_scratch
        self._keep = keep  # buffers the in-flight copies read from
        self._lanes: Optional[np.ndarray] = None

    def lanes(self) -> np.ndarray:
        """[B, n_slots, 8] uint32 lanes; blocks until the readback lands.
        Idempotent; releases the per-batch scratch on first completion."""
        if self._lanes is None:
            if self._event is not None:
                self._event.synchronize()
            self._lanes = self._lanes_host.numpy().view(np.uint32).copy()
            self._lanes_host = self._event = self._keep = None
            if self._ends_scratch is not None:
                self._fused.release_scratch(self._ends_scratch)
                self._ends_scratch = None
        return self._lanes

    def result_row(self, i: int) -> Tuple[np.ndarray, List[bytes]]:
        if self.fallback[i] is not None:
            if self._ends_scratch is not None and all(f is not None for f in self.fallback):
                # EVERY row overflowed: nobody will ask for lanes(), the only
                # other place the pooled ends scratch is released
                self.lanes()
            return self.fallback[i]
        ends = self.ends_rows[i]
        return ends, finalize_row(self.lanes()[i], ends)


class FusedCDCFP:
    """Host-side driver for call A and call B over padded same-bucket rows.

    ``__call__`` takes a [B, bucket] uint8 batch (rows zero-padded) and the
    true lengths, and returns per-row (segment ends, 16-byte digests),
    bit-identical to ``cdc_segment_ends`` + ``segment_fingerprints_host_batch``.
    ``dispatch`` is the two-phase form (see PendingBatch).
    """

    def __init__(self, params: CDCParams, pool=None, device="cuda"):
        self.params = params
        self.device = resolve_device(device)
        self.tables = device_tables(self.device)
        self.pool = pool  # optional BufferPool for the per-batch ends scratch
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None  # every launch of this driver
        self._stage_stream = torch.cuda.Stream(self.device) if cuda else None  # submit-time row uploads
        self._lock = threading.Lock()
        self.overflow_rows = 0  # rows recomputed on the host (candidate count above the cap)

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Blocking host -> device copy of a numpy array (a private copy on the CPU)."""
        host = torch.from_numpy(np.array(arr, copy=True) if not arr.flags.writeable else arr)
        return host.to(self.device, copy=True)

    def stage(self, padded: np.ndarray) -> torch.Tensor:
        """Upload ONE padded row at submit time, synchronously on the staging
        stream: when this returns the bytes are on the card, so the caller
        may recycle ``padded`` (a pooled host buffer) at once."""
        if self._stage_stream is None:
            return self._upload(padded)
        with torch.cuda.stream(self._stage_stream):
            return self._upload(padded)

    def release_scratch(self, arr: np.ndarray) -> None:
        if self.pool is not None:
            self.pool.release_scratch(arr)

    def counters(self) -> dict:
        return {"donated_batches": 0}

    def dispatch(self, batch, lens, dev_rows: Optional[list] = None) -> PendingBatch:
        """Run call A + host boundary selection and ENQUEUE call B.

        ``batch``: [B, bucket] uint8 (rows zero-padded), or a list of B 1-D
        host rows. ``dev_rows`` (rows from :meth:`stage`, or host rows whose
        staging failed) carry the compute input when given; host rows are
        then only read on the candidate-overflow fallback.
        """
        if isinstance(batch, (list, tuple)):
            host_rows = list(batch)
            b, bucket = len(host_rows), len(host_rows[0])
        else:
            host_rows = [batch[i] for i in range(batch.shape[0])]
            b, bucket = batch.shape
        cap = candidate_cap(bucket, self.params)
        n_slots = slots_cap(bucket, self.params)
        cuda = self.stream is not None
        with self._on_stream():
            if dev_rows is not None:
                rows = [r if isinstance(r, torch.Tensor) else self._upload(r) for r in dev_rows]
                if cuda:
                    for r in rows:  # staged on another stream: keep its memory until this stream is done
                        r.record_stream(self.stream)
                dev_batch = torch.stack(rows)
            elif isinstance(batch, (list, tuple)):
                dev_batch = self._upload(np.stack(host_rows))
            else:
                dev_batch = self._upload(np.ascontiguousarray(batch))
            lens_np = np.asarray(lens, np.int32)
            packed_dev = _candidates_impl(
                dev_batch, self._upload(lens_np), self.tables, mask_bits=self.params.mask_bits, cap=cap
            )
            packed = packed_dev.cpu().numpy()  # small blocking readback
        ends_rows: List[Optional[np.ndarray]] = []
        fallback: List[Optional[Tuple[np.ndarray, List[bytes]]]] = []
        ends_scratch = self.pool.acquire_scratch((b, n_slots), np.int32) if self.pool is not None else None
        try:
            ends_slots = ends_scratch if ends_scratch is not None else np.empty((b, n_slots), np.int32)
            ends_slots.fill(bucket)
            for i in range(b):
                n = int(lens_np[i])
                n_cand = int(packed[i, cap])
                if n_cand > cap:  # overflow: the compaction truncated the list
                    with self._lock:
                        self.overflow_rows += 1
                    fallback.append(_host_exact(np.asarray(host_rows[i][:n]), self.params))
                    ends_rows.append(None)
                    continue
                fallback.append(None)
                ends = select_boundaries(packed[i, :n_cand].astype(np.int64), n, self.params)
                ends_rows.append(ends)
                ends_slots[i, : len(ends)] = ends
                if n < bucket:  # one garbage end covering the zero padding
                    ends_slots[i, len(ends)] = bucket
            with self._on_stream():
                if cuda:
                    ends_pinned = torch.empty((b, n_slots), dtype=torch.int32, pin_memory=True)
                    ends_pinned.numpy()[:] = ends_slots
                    ends_dev = ends_pinned.to(self.device, non_blocking=True)
                    lanes_dev = _fp_impl(dev_batch, ends_dev, self.tables)
                    lanes_host = torch.empty(lanes_dev.shape, dtype=torch.int32, pin_memory=True)
                    lanes_host.copy_(lanes_dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self.stream)
                    keep = (ends_pinned, ends_dev, dev_batch)
                else:
                    lanes_host = _fp_impl(dev_batch, torch.from_numpy(ends_slots.copy()), self.tables)
                    event = keep = None
        except BaseException:
            if ends_scratch is not None:
                # an overflow-row recompute or a failed launch must not strand
                # the pooled scratch: only PendingBatch knows to release it
                self.pool.release_scratch(ends_scratch)
            raise
        return PendingBatch(self, b, ends_rows, fallback, lanes_host, event, ends_scratch, keep)

    def __call__(self, batch, lens, dev_rows: Optional[list] = None) -> List[Tuple[np.ndarray, List[bytes]]]:
        pending = self.dispatch(batch, lens, dev_rows=dev_rows)
        return [pending.result_row(i) for i in range(pending.b)]
