"""Multi-lane polynomial segment fingerprints over GF(2^31 - 1).

For each CDC segment s = [b_0 .. b_{L-1}] and lane base r:

    F_r(s) = sum_i b_i * r^(L-1-i)   mod M31

Eight lanes with independent bases; the 8 x uint32 lane vector and the
segment length are mixed into the 16-byte wire fingerprint with blake2b on
the host. The device functions here are the plain PyTorch versions (int64
carriers); call B on the card is the ``segment_fp`` kernel in
``ops/kernels.py``. The host functions use the native library
(``native/datapath.py``) when it is available and numpy otherwise.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from skyplane_tpu_torch.ops.gear import splitmix64_stream
from skyplane_tpu_torch.ops.u32 import M31, fold31, powmod31_table

N_LANES = 8
MAX_SEGMENT_BYTES = 1 << 18  # power table length; must cover cdc max_bytes
_BASE_SEED = 0x5EED_F1D0

# deterministic per-deployment lane bases in [2, M31-2]
LANE_BASES = (splitmix64_stream(_BASE_SEED, N_LANES) % np.uint64(M31 - 3) + np.uint64(2)).astype(np.uint32)

_power_tables_cache = None


def _power_tables() -> np.ndarray:
    """[N_LANES, MAX_SEGMENT_BYTES] uint32: r^k mod M31 per lane."""
    global _power_tables_cache
    if _power_tables_cache is None:
        _power_tables_cache = np.stack([powmod31_table(int(b), MAX_SEGMENT_BYTES) for b in LANE_BASES])
    return _power_tables_cache


def segment_fingerprint_device(
    data: torch.Tensor, seg_ids: torch.Tensor, rev_pos: torch.Tensor, n_segments: int, tables: torch.Tensor
) -> torch.Tensor:
    """Per-segment 8-lane hash by scatter-add (the oracle for the cumsum form).

    data [N] uint8, seg_ids [N] (0..n_segments-1), rev_pos [N] (< MAX_SEGMENT_BYTES),
    tables [N_LANES, MAX] int64. Returns [n_segments, N_LANES] int64 in [0, M31).
    """
    b = data.long()
    seg_ids = seg_ids.long()
    lanes = []
    for li in range(N_LANES):
        terms = fold31(b * tables[li][rev_pos.long()])
        acc = torch.zeros(n_segments, dtype=torch.int64, device=data.device)
        acc.index_add_(0, seg_ids, terms)  # < 2^31 * 2^23 per segment: exact in int64
        lanes.append(acc % M31)
    return torch.stack(lanes, dim=-1)


def segment_fingerprint_cumsum(
    data: torch.Tensor, rev_pos: torch.Tensor, seg_starts: torch.Tensor, seg_ends: torch.Tensor, tables: torch.Tensor
) -> torch.Tensor:
    """Per-segment 8-lane hash for CONTIGUOUS segments as prefix-sum differences.

    Batched along leading axes: data/rev_pos [..., N], seg_starts/seg_ends
    [..., S] (start == end for empty slots, both in [0, N]), tables
    [N_LANES, MAX] int64. Returns [..., S, N_LANES] int64 in [0, M31).
    Terms are < 2^31, so prefix sums over N <= 2^23 bytes stay exact in int64.
    """
    b = data.long()
    rev_pos = rev_pos.long()
    seg_starts = seg_starts.long()
    seg_ends = seg_ends.long()
    zero = torch.zeros(b.shape[:-1] + (1,), dtype=torch.int64, device=data.device)
    lanes = []
    for li in range(N_LANES):
        terms = fold31(b * tables[li][rev_pos])
        cs = torch.cat([zero, torch.cumsum(terms, dim=-1)], dim=-1)
        s = cs.gather(-1, seg_ends) - cs.gather(-1, seg_starts)
        lanes.append(s % M31)
    return torch.stack(lanes, dim=-1)


def fixed_stride_lanes(chunk_batch: torch.Tensor, fp_seg_bytes: int, tables) -> torch.Tensor:
    """[B, N] uint8 -> [B, N/fp_seg_bytes, 8] int32 lanes (uint32 values
    in [0, M31)) of the FIXED-stride segments, for the batch step.

    On a CUDA tensor this always launches the ``segment_fp_fixed`` kernel,
    which covers every stride that divides N up to 2^24 (the reference's
    Pallas kernel covers fewer and falls through to XLA for the rest); on the
    CPU it runs the scatter-add form above. Power indices past
    MAX_SEGMENT_BYTES - 1 are clamped in both, as JAX's gather clamps them.
    ``tables`` is the ``DeviceTables`` of the data's device.
    """
    from skyplane_tpu_torch.ops import kernels

    return kernels.segment_fp_fixed(chunk_batch, fp_seg_bytes, tables)


def finalize_fingerprint(lanes: np.ndarray, length: int) -> str:
    """Mix one segment's 8 uint32 lanes + length into the 128-bit hex wire fingerprint."""
    h = hashlib.blake2b(np.asarray(lanes, dtype="<u4").tobytes() + int(length).to_bytes(8, "little"), digest_size=16)
    return h.hexdigest()


def digests_from_lanes(lanes: np.ndarray, ends: np.ndarray) -> list:
    """[n_segments, 8] uint32 lane rows -> 16-byte wire digests (one bulk
    little-endian conversion, identical to ``finalize_fingerprint`` per row)."""
    la = np.ascontiguousarray(lanes, dtype="<u4").tobytes()
    out = []
    start = 0
    for i, end in enumerate(np.asarray(ends, np.int64).tolist()):
        h = hashlib.blake2b(la[i * 32 : i * 32 + 32] + (end - start).to_bytes(8, "little"), digest_size=16)
        out.append(h.digest())
        start = end
    return out


def _segment_lanes_np(arr: np.ndarray, starts, ends) -> np.ndarray:
    """[n_segments, 8] uint32 lanes of contiguous segments, numpy, one segment
    at a time (keeps the working set in cache)."""
    tables64 = _power_tables().astype(np.uint64)
    lanes = np.empty((len(ends), N_LANES), np.uint32)
    m31 = np.uint64(M31)
    for si, (s, e) in enumerate(zip(starts, ends)):
        d = arr[s:e].astype(np.uint64)
        length = int(e - s)
        for li in range(N_LANES):
            t = d * tables64[li, :length][::-1]  # b_i * r^(L-1-i) < 2^39
            t = (t >> np.uint64(31)) + (t & m31)  # < 2^31 + 2^8
            lanes[si, li] = int(t.sum()) % M31
    return lanes


def segment_fingerprint_host(seg: bytes) -> bytes:
    """Host recompute of one segment's 16-byte wire fingerprint (receivers
    verify literals with it before admitting them to the SegmentStore): the
    native lanes when the library is available, numpy otherwise."""
    from skyplane_tpu_torch.native import datapath as native_dp

    n = len(seg)
    if n > MAX_SEGMENT_BYTES:
        raise ValueError(f"segment length {n} exceeds MAX_SEGMENT_BYTES {MAX_SEGMENT_BYTES}")
    arr = np.frombuffer(seg, np.uint8)
    if n and native_dp.available():
        lanes = native_dp.segment_fp_lanes(arr, np.asarray([n], np.int64))
    else:
        lanes = _segment_lanes_np(arr, [0], [n])
    return bytes.fromhex(finalize_fingerprint(lanes[0], n))


def segment_fingerprints_host_batch(arr: np.ndarray, ends: np.ndarray) -> list:
    """All segment digests of one chunk on the host, in segment order (native
    lanes when the library is available, numpy otherwise)."""
    from skyplane_tpu_torch.native import datapath as native_dp

    ends = np.asarray(ends, np.int64)
    if len(arr) == 0 or len(ends) == 0:
        return []
    if native_dp.available():
        lanes = native_dp.segment_fp_lanes(arr, ends)
    else:
        lanes = _segment_lanes_np(arr, np.concatenate([[0], ends[:-1]]), ends)
    return digests_from_lanes(lanes, ends)


def segment_fingerprint_np(data: np.ndarray, boundaries: np.ndarray) -> np.ndarray:
    """Python-int reference: per-segment lanes by Horner. boundaries = segment end offsets."""
    out = np.zeros((len(boundaries), N_LANES), np.uint32)
    start = 0
    for si, end in enumerate(boundaries):
        for li, base in enumerate(LANE_BASES):
            acc = 0
            for byte in data[start:end]:
                acc = (acc * int(base) + int(byte)) % M31
            out[si, li] = acc
        start = end
    return out
