"""The fused batch step ``datapath_step`` and the host orchestration of the
data path, ``DataPathProcessor``.

``datapath_step`` is the flagship device function (what ``entry.py``
exposes): for a batch of equal-length chunks it computes the full-width CDC
candidate mask, the blockpack tags and compacted literals, and the
fixed-stride 8-lane segment fingerprints, through three CUDA kernels on one
stream of the card (``gear_mask``, ``blockpack_encode``,
``segment_fp_fixed``), or their plain versions on the CPU.

Sender (``process``): CDC boundaries and segment fingerprints on the device
(``FusedCDCFP``, micro-batched across workers by ``DeviceBatchRunner`` when
one is given) -> dedup recipe against the destination's index -> codec.
Receiver (``restore``): the exact inverse, driven by the wire header, with
optional paranoid verification that re-runs the forward path over the
restored bytes. Wire bytes are byte-identical to the JAX package's.

The processor is keyed on its device: ``"cuda"`` (default) launches the
CUDA kernels, ``"cpu"`` runs the same FusedCDCFP path through the kernels'
plain PyTorch versions.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from skyplane_tpu_torch.chunk import Codec, WireProtocolHeader
from skyplane_tpu_torch.exceptions import ChecksumMismatchException, CodecException
from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.bufpool import BufferPool, bucket_size
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.codecs import CodecSpec, get_codec, get_codec_by_id
from skyplane_tpu_torch.ops.dedup import PooledChunk, SegmentStore, SenderDedupIndex, build_recipe, parse_recipe
from skyplane_tpu_torch.state import DeviceTables, device_tables

_step_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_step_lock = threading.Lock()


def _step_stream(dev: torch.device) -> "torch.cuda.Stream":
    with _step_lock:
        s = _step_streams.get(dev)
        if s is None:
            s = _step_streams[dev] = torch.cuda.Stream(dev)
        return s


def _datapath_step_impl(batch: torch.Tensor, block_bytes: int, fp_seg_bytes: int, mask_bits: int, tables: DeviceTables):
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.blockpack import encode_device
    from skyplane_tpu_torch.ops.fingerprint import fixed_stride_lanes

    candidates = kernels.gear_mask(batch, tables, mask_bits)
    tags, literals, n_lit = encode_device(batch, block_bytes=block_bytes)
    fp_lanes = fixed_stride_lanes(batch, fp_seg_bytes, tables)
    return dict(candidates=candidates, tags=tags, literals=literals, n_lit=n_lit, fp_lanes=fp_lanes)


def datapath_step(
    batch: torch.Tensor,
    block_bytes: int = 512,
    fp_seg_bytes: int = 1 << 16,
    mask_bits: int = 16,
    tables: Optional[DeviceTables] = None,
) -> Dict[str, torch.Tensor]:
    """Fused per-batch device step. batch: [B, N] uint8 on the card (or on the
    CPU, for the plain versions); N % fp_seg_bytes == N % block_bytes == 0.

    Returns a dict of tensors on the batch's device:
      candidates [B, N] bool — CDC boundary candidates
      tags       [B, N/block_bytes] uint8 — blockpack block tags
      literals   [B, N] uint8 — compacted literal bytes (dense prefix, zero tail)
      n_lit      [B] int32 — valid literal byte count
      fp_lanes   [B, N/fp_seg_bytes, 8] int32 — fixed-stride segment
                 fingerprints (uint32 values in [0, M31))

    On the card the three kernels run on one stream of the step's own, which
    waits for the caller's stream first; the caller's stream then waits for
    it, so the outputs are ready in the caller's stream order.
    """
    if batch.dim() != 2:
        raise ValueError(f"batch must be [B, N], got shape {tuple(batch.shape)}")
    n = batch.shape[-1]
    if n % fp_seg_bytes or n % block_bytes:
        raise ValueError(f"N={n} must be divisible by fp_seg_bytes and block_bytes")
    tables = device_tables(batch.device) if tables is None else tables
    if tables.device != batch.device:
        raise ValueError(f"tables on {tables.device}, batch on {batch.device}")
    if batch.device.type == "cpu":
        return _datapath_step_impl(batch, block_bytes, fp_seg_bytes, mask_bits, tables)
    caller = torch.cuda.current_stream(batch.device)
    stream = _step_stream(batch.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        out = _datapath_step_impl(batch, block_bytes, fp_seg_bytes, mask_bits, tables)
    batch.record_stream(stream)
    caller.wait_stream(stream)
    for t in out.values():
        t.record_stream(caller)
    return out


@dataclass
class ProcessedPayload:
    """Sender-side result for one chunk."""

    wire_bytes: bytes
    codec: Codec
    is_compressed: bool
    is_recipe: bool
    raw_len: int
    fingerprint: str  # 32 hex chars, end-to-end identity of the raw bytes
    n_segments: int = 0
    n_ref_segments: int = 0
    literal_bytes: int = 0  # pre-codec literal bytes shipped (dedup mode)
    new_fingerprints: list = field(default_factory=list)  # commit to index AFTER delivery
    ref_fingerprints: list = field(default_factory=list)  # discard from index on unresolvable-ref nack


class DataPathStats:
    """Cumulative sender-side accounting, sharded per worker thread (plain
    GIL-atomic increments, merged in ``as_dict``). External counters (pool,
    batch runner) merge in through registered sources over a zero-filled
    default set, so the key schema is the JAX package's whether or not those
    subsystems are active, plus the port's stage timings.

    ``device_wait_ns``: time a worker was blocked on ends and fingerprints of
    a batch another worker ran (``BatchHandle.wait_ns``); not the leader's
    window wait, nor a batch the worker ran itself inside ``submit``.

    Stage timings (ns, always on; each the interval of the span named beside
    it, docs/observability_torch.md), counted by the sender operator that owns
    this processor: ``admit_wait_ns`` (``chunk.admit``: the POST that
    registered a chunk to the sender worker that dequeued it), ``read_ns``
    (``chunk.read``), ``encode_ns`` (``datapath.encode``: ``process``),
    ``seal_ns`` (``wire.seal``). On a relay, ``forward_wait_ns``
    (``relay.forward``: the receive operator handing a landed chunk on to a
    sender worker dequeuing it) over ``forward_chunks``, once per operator."""

    STAGE_KEYS = ("admit_wait_ns", "read_ns", "encode_ns", "seal_ns")
    RELAY_KEYS = ("forward_wait_ns", "forward_chunks")
    _KEYS = ("chunks", "raw_bytes", "wire_bytes", "segments", "ref_segments", "device_wait_ns") + STAGE_KEYS + RELAY_KEYS
    EXTERNAL_ZERO = {
        "pool_hits": 0,
        "pool_misses": 0,
        "pool_hit_rate": 0.0,
        "pool_recycled": 0,
        "pool_dropped": 0,
        "pool_evicted_bytes": 0,
        "pool_idle_bytes": 0,
        "pool_outstanding": 0,
        "batch_windows": 0,
        "batch_rows": 0,
        "batch_padded_rows": 0,
        "batch_occupancy": 0.0,
        "stage_failures": 0,
        "donated_batches": 0,
        "window_wait_ns": 0,
        "stage_ns": 0,
        "stage_bytes": 0,
        "stage_rows": 0,
    }

    def __init__(self):
        self._lock = threading.Lock()  # guards the shard/source registries only
        self._tls = threading.local()
        self._shards: List[dict] = []
        self._sources: List[Callable[[], dict]] = []

    def _shard(self) -> dict:
        d = getattr(self._tls, "counters", None)
        if d is None:
            d = {k: 0 for k in self._KEYS}
            with self._lock:
                self._shards.append(d)
            self._tls.counters = d
        return d

    def observe(self, p: ProcessedPayload) -> None:
        d = self._shard()
        d["chunks"] += 1
        d["raw_bytes"] += p.raw_len
        d["wire_bytes"] += len(p.wire_bytes)
        d["segments"] += p.n_segments
        d["ref_segments"] += p.n_ref_segments

    def observe_device_wait(self, ns: int) -> None:
        if ns:
            self._shard()["device_wait_ns"] += int(ns)

    def add(self, key: str, n: int) -> None:
        """Add ``n`` to one of the stage timings on this thread's shard."""
        self._shard()[key] += n

    def add_source(self, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._sources.append(fn)

    def as_dict(self) -> dict:
        with self._lock:
            shards = list(self._shards)
            sources = list(self._sources)
        out = {k: 0 for k in self._KEYS}
        for d in shards:
            for k in self._KEYS:
                out[k] += d[k]
        out["compression_ratio"] = out["raw_bytes"] / out["wire_bytes"] if out["wire_bytes"] else 1.0
        merged = dict(self.EXTERNAL_ZERO)
        for fn in sources:
            merged.update(fn())
        out.update(merged)
        return out


def effective_codec_name(codec_name: str, device="cuda") -> str:
    """The codec a gateway runs for a configured name on ``device``:
    ``tpu_zstd`` becomes plain ``zstd`` on the CPU (the codec id travels in
    each wire header, so mixed gateways interoperate); every other name is
    kept. ``SKYPLANE_TPU_KEEP_TPU_CODEC=1`` keeps ``tpu_zstd`` on the CPU too."""
    if codec_name != "tpu_zstd" or os.environ.get("SKYPLANE_TPU_KEEP_TPU_CODEC") == "1":
        return codec_name
    return codec_name if resolve_device(device).type == "cuda" else "zstd"


class _PhasedCDC:
    """Two-phase CDC result: ``ends`` are final at construction; ``fps()``
    blocks until the segment fingerprints land."""

    __slots__ = ("ends", "_fps_fn", "_wait_ns_fn")

    def __init__(self, ends, fps_fn, wait_ns_fn=None):
        self.ends = ends
        self._fps_fn = fps_fn
        self._wait_ns_fn = wait_ns_fn

    def fps(self):
        return self._fps_fn()

    @property
    def wait_ns(self) -> int:
        return self._wait_ns_fn() if self._wait_ns_fn is not None else 0


class DataPathProcessor:
    """Per-connection host orchestrator for the data path.

    Encode (sender): CDC -> segment fingerprints -> dedup recipe -> codec, or
    the plain codec when dedup is off. Decode (receiver) is the exact
    inverse, driven by the wire header's codec and flags.
    """

    def __init__(
        self,
        codec_name: str = "tpu_zstd",
        dedup: bool = True,
        cdc_params: CDCParams = CDCParams(),
        verify_checksums: bool = True,
        batch_runner=None,
        paranoid_verify: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # a remote runner (a pump worker's proxy for the parent daemon's
        # runner, gateway/pump.py) has no device here: its kernels run in the
        # parent, on the parent's card
        remote = batch_runner is not None and getattr(batch_runner, "remote", False)
        if batch_runner is not None and not remote and batch_runner.device != self.device:
            raise ValueError(f"batch runner on {batch_runner.device}, processor on {self.device}")
        self.codec: CodecSpec = get_codec(codec_name)
        self.dedup = dedup
        self.cdc_params = cdc_params
        self.verify_checksums = verify_checksums
        self.batch_runner = batch_runner  # shared DeviceBatchRunner across the worker pool
        self.paranoid_verify = paranoid_verify  # receivers re-fingerprint restored recipe chunks
        self._fused = None  # lazy FusedCDCFP for the unbatched path
        # paranoid-verify counters (receiver): recipe chunks re-fingerprinted,
        # and how many of them went through the shared batch runner
        self._verify_total = 0
        self._verify_batched = 0
        self.bufpool = batch_runner.pool if batch_runner is not None else BufferPool()
        self.stats = DataPathStats()
        if batch_runner is not None:
            self.stats.add_source(batch_runner.counters)
        else:
            self.stats.add_source(self.bufpool.counters)
            self.stats.add_source(lambda: self._fused.counters() if self._fused is not None else {})

    # ---- fingerprints ----

    def _cdc_and_fps_phased(self, arr: np.ndarray) -> _PhasedCDC:
        """CDC boundaries + segment fingerprints on the device. The handle's
        ``.ends`` are final at once; ``.fps()`` may block on the readback, so
        callers cut recipe spans in between."""
        if self.batch_runner is not None:
            # first, before any device work: a pump worker's remote runner
            # ships the chunk to the parent daemon's runner on the card
            if self.batch_runner.cdc_params != self.cdc_params:
                raise ValueError("batch runner CDC params diverge from the processor's")
            handle = self.batch_runner.submit(arr)
            return _PhasedCDC(handle.ends(), handle.fps, wait_ns_fn=lambda: handle.wait_ns)
        if self._fused is None:
            from skyplane_tpu_torch.ops.fused_cdc import FusedCDCFP

            self._fused = FusedCDCFP(self.cdc_params, pool=self.bufpool, device=self.device)
        bucket = bucket_size(len(arr))
        if len(arr) == bucket:
            # a whole bucket already: no pooled copy (the upload copies)
            ends, fps = self._fused(arr[None, :], [len(arr)])[0]
            return _PhasedCDC(ends, lambda: fps)
        padded = self.bufpool.acquire(bucket)
        try:
            padded[: len(arr)] = arr
            padded[len(arr) :] = 0
            ends, fps = self._fused(padded[None, :], [len(arr)])[0]
        finally:
            self.bufpool.release(padded)
        return _PhasedCDC(ends, lambda: fps)

    def _cdc_and_fps(self, arr: np.ndarray):
        phased = self._cdc_and_fps_phased(arr)
        return phased.ends, phased.fps()

    @staticmethod
    def _chunk_fingerprint(seg_fps: List[bytes], raw_len: int) -> str:
        h = hashlib.blake2b(b"".join(seg_fps) + raw_len.to_bytes(8, "little"), digest_size=16)
        return h.hexdigest()

    # ---- encode ----

    def process(self, data: bytes, index: Optional[SenderDedupIndex] = None) -> ProcessedPayload:
        raw_len = len(data)
        if self.dedup and index is not None and raw_len > 0:
            phased = self._cdc_and_fps_phased(np.frombuffer(data, np.uint8))
            # spans are cut while this worker's fingerprint readback is in flight
            mv = memoryview(data)
            spans = []
            start = 0
            for end in np.asarray(phased.ends).tolist():
                spans.append(mv[start:end])
                start = end
            seg_fps = phased.fps()
            self.stats.observe_device_wait(phased.wait_ns)
            segments = list(zip(seg_fps, spans))
            wire, n_ref, lit_bytes, new_fps, ref_fps = build_recipe(segments, index, self.codec.encode)
            payload = ProcessedPayload(
                wire_bytes=wire,
                codec=self.codec.codec_id,
                is_compressed=self.codec.codec_id != Codec.NONE,
                is_recipe=True,
                raw_len=raw_len,
                fingerprint=self._chunk_fingerprint(seg_fps, raw_len),
                n_segments=len(segments),
                n_ref_segments=n_ref,
                literal_bytes=lit_bytes,
                new_fingerprints=new_fps,
                ref_fingerprints=ref_fps,
            )
        else:
            wire = self.codec.encode(data)
            if len(wire) >= raw_len and self.codec.codec_id != Codec.NONE:
                wire, codec_id = data, Codec.NONE  # incompressible: ship raw
            else:
                codec_id = self.codec.codec_id
            payload = ProcessedPayload(
                wire_bytes=wire,
                codec=codec_id,
                is_compressed=codec_id != Codec.NONE,
                is_recipe=False,
                raw_len=raw_len,
                fingerprint=hashlib.blake2b(data, digest_size=16).hexdigest(),
            )
        self.stats.observe(payload)
        return payload

    # ---- decode ----

    def verify_counters(self) -> dict:
        """Paranoid-verify counters, in the receiver's decode schema."""
        return {"verify_total": self._verify_total, "verify_batched": self._verify_batched}

    def restore(
        self,
        payload: bytes,
        header: WireProtocolHeader,
        store: Optional[SegmentStore] = None,
        ref_wait_timeout: float = 60.0,
        pooled: bool = False,
    ):
        """Wire payload -> raw chunk bytes, driven by the wire header. With
        ``pooled``, recipe payloads assemble into a pooled buffer and a
        :class:`PooledChunk` is returned; otherwise ``bytes``."""
        codec = get_codec_by_id(header.codec)
        if header.is_recipe:
            if store is None:
                raise CodecException("recipe payload but no SegmentStore configured")
            data = parse_recipe(
                payload,
                store,
                codec.decode,
                ref_wait_timeout=ref_wait_timeout,
                verify_literals=self.verify_checksums,
                out_pool=self.bufpool if pooled else None,
                expected_raw_len=header.raw_data_len,
            )
        else:
            data = codec.decode(payload)
        view = data.view if isinstance(data, PooledChunk) else data
        try:
            if len(view) != header.raw_data_len:
                raise ChecksumMismatchException(
                    f"chunk {header.chunk_id}: raw length {len(view)} != header {header.raw_data_len}"
                )
            if self.verify_checksums and not header.is_recipe and header.fingerprint != "0" * 32:
                if hashlib.blake2b(view, digest_size=16).hexdigest() != header.fingerprint:
                    raise ChecksumMismatchException(f"chunk {header.chunk_id}: fingerprint mismatch")
            if self.paranoid_verify and header.is_recipe and header.fingerprint != "0" * 32:
                # re-chunk the restored bytes and rebuild the sender's chunk fingerprint
                self._verify_total += 1
                if self.batch_runner is not None and self.device.type == "cuda":
                    self._verify_batched += 1
                _, seg_fps = self._cdc_and_fps(np.frombuffer(view, np.uint8))
                if self._chunk_fingerprint(seg_fps, len(view)) != header.fingerprint:
                    raise ChecksumMismatchException(
                        f"chunk {header.chunk_id}: paranoid recipe verification failed "
                        "(restored bytes re-fingerprint differently)"
                    )
        except BaseException:
            if isinstance(data, PooledChunk):
                data.release()
            raise
        return data
