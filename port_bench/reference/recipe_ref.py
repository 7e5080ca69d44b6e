"""Plain NumPy reference of the dedup recipe's segments and fingerprints.

What the configuration states, worked out from the bytes alone: the
content-defined chunking of one chunk (a 32-byte Gear hash, a cut candidate
where its top ``log2(avg)`` bits are zero, then min/max lengths enforced
greedily) and each segment's 16-byte wire fingerprint (eight polynomial
lanes over GF(2^31 - 1), mixed with the segment length by blake2b). The
Gear table and the lane bases are derived here from the deployment's stated
seeds by splitmix64, as every gateway of a deployment derives them: this
module imports nothing of the program and takes no table from it.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Tuple

import numpy as np

M31 = (1 << 31) - 1
GEAR_SEED = 0x5EED_CDC1
LANE_SEED = 0x5EED_F1D0
N_LANES = 8
GEAR_WINDOW = 32
_M64 = (1 << 64) - 1


def splitmix64(seed: int, n: int) -> List[int]:
    out, x = [], seed & _M64
    for _ in range(n):
        x = (x + 0x9E3779B97F4A7C15) & _M64
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        out.append(z ^ (z >> 31))
    return out


@lru_cache(maxsize=1)
def gear_table() -> np.ndarray:
    return np.asarray([v & 0xFFFFFFFF for v in splitmix64(GEAR_SEED, 256)], np.uint32)


@lru_cache(maxsize=1)
def lane_bases() -> Tuple[int, ...]:
    return tuple(v % (M31 - 3) + 2 for v in splitmix64(LANE_SEED, N_LANES))


@lru_cache(maxsize=4)
def lane_powers(n: int) -> np.ndarray:
    """[N_LANES, n] uint64: base^k mod M31 for k < n."""
    out = np.empty((N_LANES, n), np.uint64)
    for li, base in enumerate(lane_bases()):
        p = 1
        row = out[li]
        for k in range(n):
            row[k] = p
            p = p * base % M31
    return out


def gear_hashes(data: np.ndarray) -> np.ndarray:
    """h_t = sum_{i<32} G[b_{t-i}] << i mod 2^32, with zeros before the chunk
    (the classic loop ``h = (h << 1) + G[b]`` from h = 0)."""
    h = gear_table()[data]
    off = 1
    while off < GEAR_WINDOW:
        h[off:] += h[:-off] << np.uint32(off)  # the right side is a new array; uint32 wraps mod 2^32
        off <<= 1
    return h


def segment_ends(data: np.ndarray, min_bytes: int, avg_bytes: int, max_bytes: int) -> np.ndarray:
    """Segment end offsets of one chunk; the last is len(data)."""
    n = len(data)
    mask_bits = max(1, avg_bytes.bit_length() - 1)
    cands = np.flatnonzero((gear_hashes(data) >> np.uint32(32 - mask_bits)) == 0)
    ends: List[int] = []
    start = 0
    for p in cands.tolist():
        cut = p + 1
        if cut - start < min_bytes:
            continue
        while cut - start > max_bytes:
            start += max_bytes
            ends.append(start)
        if cut - start >= min_bytes:
            ends.append(cut)
            start = cut
    while n - start > max_bytes:
        start += max_bytes
        ends.append(start)
    if start < n or not ends:
        ends.append(n)
    return np.asarray(ends, np.int64)


def segment_lanes(data: np.ndarray, ends: np.ndarray, max_bytes: int) -> np.ndarray:
    """[n_segments, 8] lanes: sum_i b_i * r^(L-1-i) mod M31 per segment, one
    product of the segment's bytes with the reversed powers a segment. Each
    term is below 2^39 and a segment has at most 2^16 of them, so the sums
    are exact in uint64."""
    starts = np.concatenate([[0], ends[:-1]])
    powers = lane_powers(int(max(max_bytes, (ends - starts).max())))
    b = data.astype(np.uint64)
    out = np.empty((len(ends), N_LANES), np.uint64)
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        out[i] = powers[:, e - s - 1 :: -1] @ b[s:e]
    return (out % np.uint64(M31)).astype(np.uint32)


def fingerprints(lanes: np.ndarray, ends: np.ndarray) -> List[bytes]:
    """16-byte wire fingerprint per segment: blake2b over the lanes as
    little-endian u32 and the segment length as a little-endian u64."""
    out, start = [], 0
    for row, end in zip(lanes, ends.tolist()):
        msg = np.asarray(row, "<u4").tobytes() + (end - start).to_bytes(8, "little")
        out.append(hashlib.blake2b(msg, digest_size=16).digest())
        start = end
    return out


def recipe(data: np.ndarray, cdc: dict) -> List[Tuple[int, bytes]]:
    """(segment length, fingerprint) of every segment of one chunk, in order."""
    data = np.asarray(data, np.uint8)
    ends = segment_ends(data, cdc["min_bytes"], cdc["avg_bytes"], cdc["max_bytes"])
    lens = np.diff(np.concatenate([[0], ends])).tolist()
    return list(zip(lens, fingerprints(segment_lanes(data, ends, cdc["max_bytes"]), ends)))
