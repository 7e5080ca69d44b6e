"""Cross-object dedup: sender-side fingerprint index, receiver-side segment
store, and the recipe wire format (byte-identical to the JAX package's).

A chunk processed with dedup on becomes a *recipe*: an ordered list of
segments, each a REF (16-byte fingerprint the receiver already holds) or a
LITERAL (bytes carried in this frame, codec-compressed as one blob).

Consistency contract: a sender only emits REF(fp) after it emitted
LITERAL(fp) on the same ordered channel, and the receiver stores every
literal before acking the chunk, so refs resolve in order. A REF that races
ahead of its literal (parallel sockets or decode workers) waits a bounded
time for it to land.

Recipe container layout (little-endian):
  magic 0xDE 0xD1 | ver(1) | n_entries(4) | entry... | lit_blob
  entry: kind(1: 0=REF 1=LIT) | fp(16) | seg_len(8)
  lit_blob: codec-compressed concatenation of LITERAL segment bytes.

This slice's ``SegmentStore`` is memory-only (an evicted segment is gone; a
later REF to it fails and the sender resends literals).
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from skyplane_tpu_torch.exceptions import CodecException, DedupIntegrityException
from skyplane_tpu_torch.ops.bufpool import BufferPool, bucket_size
from skyplane_tpu_torch.ops.fingerprint import segment_fingerprint_host

MAGIC = b"\xde\xd1"
VERSION = 1
_ENTRY = struct.Struct("<B16sQ")
KIND_REF = 0
KIND_LIT = 1
# hard cap on the raw bytes a recipe may claim to restore to
MAX_RECIPE_RAW_BYTES = 8 << 30


def _pow2_at_least(n: int) -> int:
    m = 1
    while m < max(1, int(n)):
        m <<= 1
    return m


class _IndexStripe:
    __slots__ = ("lock", "lru", "bytes")

    def __init__(self):
        self.lock = threading.Lock()
        self.lru: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()  # fp -> (size, last-touch seq)
        self.bytes = 0


class SenderDedupIndex:
    """Bounded LRU of fingerprints known to be resident at one destination.

    Bounded by segment bytes, sized strictly below the receiver's store
    capacity. Lookups and inserts lock only the stripe chosen by the
    fingerprint's first byte; eviction removes the globally least recently
    touched entry (a monotonic touch sequence per entry).
    """

    def __init__(self, max_bytes: int = 16 << 30, stripes: int = 16):
        n = _pow2_at_least(stripes)
        self._stripes = [_IndexStripe() for _ in range(n)]
        self._mask = n - 1
        self._seq = itertools.count()  # GIL-atomic next()
        self._budget_lock = threading.Lock()  # guards the global byte total
        self._max_bytes = max_bytes
        self._bytes = 0

    def _stripe(self, fp: bytes) -> _IndexStripe:
        return self._stripes[fp[0] & self._mask]

    def __contains__(self, fp: bytes) -> bool:
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.get(fp)
            if entry is None:
                return False
            s.lru[fp] = (entry[0], next(self._seq))
            s.lru.move_to_end(fp)
            return True

    def add(self, fp: bytes, size: int = 0) -> None:
        """Insert or touch a fingerprint."""
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.get(fp)
            if entry is not None:
                s.lru[fp] = (entry[0], next(self._seq))
                s.lru.move_to_end(fp)
                return
            s.lru[fp] = (size, next(self._seq))
            s.bytes += size
        with self._budget_lock:
            self._bytes += size
        self._evict_to_budget()

    def discard(self, fp: bytes) -> None:
        """Forget a fingerprint (the receiver nacked an unresolvable REF to it)."""
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.pop(fp, None)
            if entry is None:
                return
            s.bytes -= entry[0]
        with self._budget_lock:
            self._bytes -= entry[0]

    def _evict_to_budget(self) -> None:
        """Evict globally-oldest entries until the byte bound holds, one stripe lock at a time."""
        while True:
            with self._budget_lock:
                if self._bytes <= self._max_bytes:
                    return
            victim: Optional[_IndexStripe] = None
            victim_seq = None
            for s in self._stripes:
                with s.lock:
                    if s.lru:
                        _, (_, seq) = next(iter(s.lru.items()))
                        if victim_seq is None or seq < victim_seq:
                            victim, victim_seq = s, seq
            if victim is None:
                return
            with victim.lock:
                if not victim.lru:
                    continue  # raced with a discard; rescan
                _, (size, _) = victim.lru.popitem(last=False)
                victim.bytes -= size
            with self._budget_lock:
                self._bytes -= size


class _StoreStripe:
    __slots__ = ("lock", "mem", "waiters")

    def __init__(self):
        self.lock = threading.Lock()
        self.mem: "OrderedDict[bytes, list]" = OrderedDict()  # fp -> [data, last-touch seq]
        self.waiters: Dict[bytes, list] = {}  # fp -> [arrival Event, waiter refcount]


class SegmentStore:
    """Receiver-side fingerprint -> segment bytes store, in memory.

    LRU bounded by bytes with globally ordered eviction; striped by the
    fingerprint's first byte. A REF that arrives before its LITERAL parks on
    a per-fingerprint arrival event that ``put`` sets, for at most the
    caller's ``wait_timeout``.
    """

    def __init__(self, max_bytes: int = 4 << 30, stripes: int = 16):
        n = _pow2_at_least(stripes)
        self._stripes = [_StoreStripe() for _ in range(n)]
        self._mask = n - 1
        self._seq = itertools.count()
        self._budget_lock = threading.Lock()
        self._max_bytes = max_bytes
        self._mem_bytes = 0

    def _stripe(self, fp: bytes) -> _StoreStripe:
        return self._stripes[fp[0] & self._mask]

    def put(self, fp: bytes, data: bytes) -> None:
        s = self._stripe(fp)
        added = 0
        with s.lock:
            entry = s.mem.get(fp)
            if entry is not None:
                entry[1] = next(self._seq)
                s.mem.move_to_end(fp)
            else:
                s.mem[fp] = [data, next(self._seq)]
                added = len(data)
            waiter = s.waiters.pop(fp, None)
        if waiter is not None:
            waiter[0].set()
        if added:
            with self._budget_lock:
                self._mem_bytes += added
            self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        while True:
            with self._budget_lock:
                if self._mem_bytes <= self._max_bytes:
                    return
            victim: Optional[_StoreStripe] = None
            victim_seq = None
            for s in self._stripes:
                with s.lock:
                    if s.mem:
                        head = next(iter(s.mem.values()))
                        if victim_seq is None or head[1] < victim_seq:
                            victim, victim_seq = s, head[1]
            if victim is None:
                return
            with victim.lock:
                if not victim.mem:
                    continue
                _, (data, _) = victim.mem.popitem(last=False)
            with self._budget_lock:
                self._mem_bytes -= len(data)

    def _lookup(self, s: _StoreStripe, fp: bytes) -> Optional[bytes]:
        """Stripe lock held. Hit: refresh recency and return the bytes."""
        entry = s.mem.get(fp)
        if entry is None:
            return None
        entry[1] = next(self._seq)
        s.mem.move_to_end(fp)
        return entry[0]

    def get(self, fp: bytes, wait_timeout: float = 0.0) -> bytes:
        """Resolve a fingerprint, waiting up to ``wait_timeout`` s for an in-flight literal."""
        deadline = time.monotonic() + wait_timeout
        s = self._stripe(fp)
        while True:
            # register as a waiter in the same critical section as the miss,
            # so a put() landing right after cannot be lost
            with s.lock:
                data = self._lookup(s, fp)
                if data is not None:
                    return data
                waiter = s.waiters.get(fp)
                if waiter is None:
                    waiter = s.waiters[fp] = [threading.Event(), 0]
                waiter[1] += 1
            try:
                remaining = deadline - time.monotonic()
                fired = False
                if remaining > 0:
                    fired = waiter[0].wait(remaining)
            finally:
                with s.lock:
                    waiter[1] -= 1
                    if waiter[1] <= 0 and not waiter[0].is_set() and s.waiters.get(fp) is waiter:
                        del s.waiters[fp]
            if not fired:
                raise DedupIntegrityException(f"unresolvable dedup ref {fp.hex()}")

    def __contains__(self, fp: bytes) -> bool:
        s = self._stripe(fp)
        with s.lock:
            return fp in s.mem


def build_recipe(
    segments: List[Tuple[bytes, bytes]],  # [(fp16, seg_bytes), ...] in order
    index: SenderDedupIndex,
    encode_blob,
) -> Tuple[bytes, int, int, list, List[bytes]]:
    """Assemble a recipe for one chunk.

    Returns (wire_bytes, n_ref_segments, n_literal_bytes_pre_codec,
    new_fingerprints as [(fp, size), ...], ref_fingerprints as [fp, ...]).
    The index is NOT mutated: the caller commits ``new_fingerprints`` only
    after the frame is delivered, and discards ``ref_fingerprints`` if the
    receiver nacks an unresolvable REF. Repeats within the chunk are deduped.
    """
    entries = bytearray()
    lit_parts: List[bytes] = []
    emitted_here: set = set()
    new_fps: list = []
    ref_fps: List[bytes] = []
    for fp, seg in segments:
        if fp in index or fp in emitted_here:
            entries += _ENTRY.pack(KIND_REF, fp, len(seg))
            ref_fps.append(fp)
        else:
            entries += _ENTRY.pack(KIND_LIT, fp, len(seg))
            lit_parts.append(seg)
            emitted_here.add(fp)
            new_fps.append((fp, len(seg)))
    lit_blob = encode_blob(b"".join(lit_parts))
    head = MAGIC + struct.pack("<BI", VERSION, len(segments))
    return head + bytes(entries) + lit_blob, len(ref_fps), sum(len(p) for p in lit_parts), new_fps, ref_fps


class PooledChunk:
    """Restored chunk bytes assembled in a pooled buffer. ``view`` covers
    exactly the chunk; ``release()`` returns the buffer and invalidates it."""

    __slots__ = ("_arr", "_pool", "view")

    def __init__(self, arr: np.ndarray, pool: BufferPool, n: int):
        self._arr = arr
        self._pool = pool
        self.view = memoryview(arr)[:n]

    def __len__(self) -> int:
        return len(self.view)

    def release(self) -> None:
        if self._arr is None:
            return
        self.view.release()
        self._pool.release(self._arr)
        self._arr = None


def parse_recipe(
    buf: bytes,
    store: SegmentStore,
    decode_blob,
    ref_wait_timeout: float = 0.0,
    verify_literals: bool = False,
    out_pool: Optional[BufferPool] = None,
    expected_raw_len: Optional[int] = None,
):
    """Receiver side: resolve a recipe back into raw chunk bytes.

    The entry-claimed total is checked against ``expected_raw_len`` before
    any allocation. Every literal is stored so later refs resolve; with
    ``verify_literals`` its fingerprint is recomputed first. With
    ``out_pool`` the chunk assembles into a pooled buffer and a
    :class:`PooledChunk` is returned, else ``bytes``.
    """
    head_len = 2 + struct.calcsize("<BI")
    if len(buf) < head_len or buf[:2] != MAGIC:
        raise CodecException("not a dedup recipe (bad magic / truncated header)")
    ver, n_entries = struct.unpack_from("<BI", buf, 2)
    if ver != VERSION:
        raise CodecException(f"unsupported recipe version {ver}")
    off = head_len
    if n_entries * _ENTRY.size > len(buf) - off:
        raise CodecException(f"recipe claims {n_entries} entries but only {len(buf) - off} bytes follow")
    entries = []
    total = 0
    for _ in range(n_entries):
        kind, fp, seg_len = _ENTRY.unpack_from(buf, off)
        off += _ENTRY.size
        entries.append((kind, fp, seg_len))
        total += seg_len
    if total > MAX_RECIPE_RAW_BYTES:
        raise CodecException(f"recipe claims {total} raw bytes (> {MAX_RECIPE_RAW_BYTES} cap)")
    if expected_raw_len is not None and total != expected_raw_len:
        raise CodecException(f"recipe entries claim {total} raw bytes but the header declared {expected_raw_len}")
    lit_blob = decode_blob(buf[off:])
    arr: Optional[np.ndarray] = None
    if out_pool is not None and total > 0:
        arr = out_pool.acquire(bucket_size(total))
    out: List[bytes] = []
    out_off = 0
    lit_off = 0
    try:
        for kind, fp, seg_len in entries:
            if kind == KIND_LIT:
                seg = lit_blob[lit_off : lit_off + seg_len]
                if len(seg) != seg_len:
                    raise DedupIntegrityException("literal blob shorter than recipe entries")
                lit_off += seg_len
                if verify_literals and segment_fingerprint_host(seg) != fp:
                    raise DedupIntegrityException(f"literal segment fingerprint mismatch (claimed {fp.hex()})")
                store.put(fp, seg)
            elif kind == KIND_REF:
                seg = store.get(fp, wait_timeout=ref_wait_timeout)
                if len(seg) != seg_len:
                    raise DedupIntegrityException(f"dedup ref {fp.hex()} length mismatch")
            else:
                raise CodecException(f"bad recipe entry kind {kind}")
            if arr is not None:
                arr[out_off : out_off + seg_len] = np.frombuffer(seg, np.uint8)
                out_off += seg_len
            else:
                out.append(seg)
        if lit_off != len(lit_blob):
            raise DedupIntegrityException("literal blob longer than recipe entries")
    except BaseException:
        if arr is not None:
            out_pool.release(arr)  # a failed decode must not leak the buffer
        raise
    if arr is not None:
        return PooledChunk(arr, out_pool, total)
    return b"".join(out)
