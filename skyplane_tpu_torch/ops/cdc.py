"""Content-defined chunking: boundary selection and the full host CDC.

Hashing every byte runs on the card (call A in ops/fused_cdc.py). What
remains, enforcing min/max segment lengths over the sparse candidate list, is
a greedy sequential pass over a few hundred positions per 8 MiB chunk and
runs on the host. Boundaries are a pure function of the chunk bytes and the
(min, avg, max) parameters, so sender, receiver and dedup index agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from skyplane_tpu_torch.ops.fingerprint import MAX_SEGMENT_BYTES


@dataclass(frozen=True)
class CDCParams:
    min_bytes: int = 4 * 1024
    avg_bytes: int = 16 * 1024
    max_bytes: int = 64 * 1024

    def __post_init__(self):
        if not (0 < self.min_bytes <= self.avg_bytes <= self.max_bytes):
            raise ValueError(f"CDC params must satisfy 0 < min <= avg <= max, got {self}")
        if self.max_bytes > MAX_SEGMENT_BYTES:
            # the power tables cover MAX_SEGMENT_BYTES; beyond it positions alias
            raise ValueError(f"cdc max_bytes {self.max_bytes} exceeds fingerprint MAX_SEGMENT_BYTES {MAX_SEGMENT_BYTES}")

    @property
    def mask_bits(self) -> int:
        return max(1, int(np.log2(self.avg_bytes)))


def select_boundaries(candidates: np.ndarray, n: int, params: CDCParams) -> np.ndarray:
    """Greedy min/max enforcement over sorted candidate positions.

    A candidate p ends a segment after byte p (cut at p+1). Returns segment
    end offsets, always terminated by n.
    """
    ends: List[int] = []
    start = 0
    for p in candidates:
        cut = int(p) + 1
        if cut - start < params.min_bytes:
            continue
        while cut - start > params.max_bytes:  # honor max: forced cuts first
            start += params.max_bytes
            ends.append(start)
        if cut - start >= params.min_bytes:
            ends.append(cut)
            start = cut
    while n - start > params.max_bytes:
        start += params.max_bytes
        ends.append(start)
    if start < n or not ends:
        ends.append(n)
    return np.asarray(ends, dtype=np.int64)


def cdc_segment_ends(data, params: CDCParams = CDCParams()) -> np.ndarray:
    """Full CDC of one chunk on the host: segment end offsets, last == len(data).
    The native gear pass when the library is available, numpy otherwise
    (bit-identical)."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    if len(arr) == 0:
        return np.asarray([0], dtype=np.int64)
    from skyplane_tpu_torch.native import datapath as native_dp

    if native_dp.available():
        mask = native_dp.gear_candidates(arr, params.mask_bits)
    else:
        from skyplane_tpu_torch.ops.host_fallback import boundary_candidates_host, gear_hash_host

        mask = boundary_candidates_host(gear_hash_host(arr), params.mask_bits)
    return select_boundaries(np.flatnonzero(mask), len(arr), params)


def cdc_and_fps_host(arr, params: CDCParams = CDCParams()) -> Tuple[np.ndarray, list]:
    """Host CDC + segment digests: (ends, [16-byte digest, ...]). One fused
    native call (gear candidates, boundary selection and lanes) when the
    library is available, the two-stage path otherwise."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.fingerprint import digests_from_lanes, segment_fingerprints_host_batch

    arr = np.frombuffer(arr, np.uint8) if isinstance(arr, (bytes, bytearray, memoryview)) else np.asarray(arr, np.uint8)
    # the fused call keeps candidate positions in u32: chunks of 4 GiB or
    # more (MAX_CHUNK_BYTES allows 8 GiB) take the two-stage int64 path
    if len(arr) and len(arr) < (1 << 32) and native_dp.available():
        ends, lanes = native_dp.cdc_fp(arr, params.mask_bits, params.min_bytes, params.max_bytes)
        return ends, digests_from_lanes(lanes, ends)
    ends = cdc_segment_ends(arr, params)
    return ends, segment_fingerprints_host_batch(arr, ends)
