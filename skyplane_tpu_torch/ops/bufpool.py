"""Bucket-keyed pool of reusable padded host buffers for the data path.

Every chunk is padded to a power-of-two bucket before upload; the pool
recycles those buffers so steady-state traffic allocates nothing per chunk
(the ``pool_misses`` counter stops moving). The receiver draws its restored
chunk buffers (``ops/dedup.py`` ``PooledChunk``) from the same pool.

Ownership contract:

  * ``acquire(bucket)`` returns a writable uint8 buffer of exactly ``bucket``
    bytes with ARBITRARY contents; the caller overwrites ``[:n]`` and zeroes
    ``[n:]`` itself.
  * ``release(buf)`` recycles a buffer issued by ``acquire``. Foreign buffers
    are ignored, so a release can never alias caller memory into another
    chunk's buffer.
  * An acquired buffer that is never released is simply garbage-collected;
    the outstanding map is bounded and forgets its oldest entries.

``acquire_scratch`` extends the same recycling to small per-batch metadata
arrays keyed by (shape, dtype). One mutex guards the free lists and counters.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

MIN_BUCKET = 1 << 16  # 64 KiB — smallest padded upload worth a device dispatch


def bucket_size(n: int) -> int:
    """Power-of-two bucket for an ``n``-byte chunk, floored at MIN_BUCKET."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


class BufferPool:
    def __init__(self, max_per_bucket: int = 32, max_total_bytes: int = 4 << 30, max_outstanding_tracked: int = 4096):
        # bucket -> LIFO of idle buffers; OrderedDict order gives LRU eviction
        self._free: "OrderedDict[int, List[np.ndarray]]" = OrderedDict()
        self._free_bytes = 0
        self._max_per_bucket = max(1, int(max_per_bucket))
        self._max_total_bytes = max(0, int(max_total_bytes))
        # issued and not yet released, id -> array (holding it keeps the id stable)
        self._outstanding: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._max_outstanding = max(1, int(max_outstanding_tracked))
        self._scratch: Dict[Tuple[Tuple[int, ...], str], List[np.ndarray]] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._recycled = 0
        self._dropped = 0
        self._evicted_bytes = 0

    def acquire(self, bucket: int) -> np.ndarray:
        """A writable uint8 buffer of ``bucket`` bytes (contents arbitrary)."""
        with self._lock:
            free = self._free.get(bucket)
            if free:
                buf = free.pop()
                self._free_bytes -= bucket
                self._free.move_to_end(bucket)
                self._hits += 1
                self._track_outstanding(buf)
                return buf
            self._misses += 1
        buf = np.empty(bucket, np.uint8)
        with self._lock:
            self._track_outstanding(buf)
        return buf

    def release(self, buf: np.ndarray) -> None:
        """Recycle a pool-issued buffer; silently ignores foreign buffers."""
        with self._lock:
            if self._outstanding.pop(id(buf), None) is None:
                return
            bucket = len(buf)
            free = self._free.setdefault(bucket, [])
            if len(free) >= self._max_per_bucket:
                self._dropped += 1
                return
            free.append(buf)
            self._free_bytes += bucket
            self._free.move_to_end(bucket)
            self._recycled += 1
            self._evict_lru_buckets()

    def _track_outstanding(self, buf: np.ndarray) -> None:
        """Lock held. Remember an issued buffer, bounding the map."""
        self._outstanding[id(buf)] = buf
        while len(self._outstanding) > self._max_outstanding:
            self._outstanding.popitem(last=False)

    def _evict_lru_buckets(self) -> None:
        """Lock held. Drop idle buffers of the least-recently-used buckets
        until the byte bound holds."""
        while self._free_bytes > self._max_total_bytes and self._free:
            bucket, free = next(iter(self._free.items()))
            if free:
                free.pop()
                self._free_bytes -= bucket
                self._evicted_bytes += bucket
            if not free:
                del self._free[bucket]

    def acquire_scratch(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A reusable scratch array (contents arbitrary) keyed by shape+dtype."""
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._scratch.get(key)
            if free:
                self._hits += 1
                arr = free.pop()
                self._track_outstanding(arr)
                return arr
            self._misses += 1
        arr = np.empty(shape, dtype)
        with self._lock:
            self._track_outstanding(arr)
        return arr

    def release_scratch(self, arr: np.ndarray) -> None:
        """Recycle a pool-issued scratch array (foreign/double releases ignored)."""
        with self._lock:
            if self._outstanding.pop(id(arr), None) is None:
                return
            key = (tuple(arr.shape), arr.dtype.str)
            free = self._scratch.setdefault(key, [])
            if len(free) < self._max_per_bucket:
                free.append(arr)
                self._recycled += 1
            else:
                self._dropped += 1

    def counters(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "pool_hits": self._hits,
                "pool_misses": self._misses,
                "pool_hit_rate": round(self._hits / total, 4) if total else 0.0,
                "pool_recycled": self._recycled,
                "pool_dropped": self._dropped,
                "pool_evicted_bytes": self._evicted_bytes,
                "pool_idle_bytes": self._free_bytes,
                "pool_outstanding": len(self._outstanding),
            }
