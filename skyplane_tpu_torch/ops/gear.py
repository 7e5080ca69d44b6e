"""Gear rolling hash for content-defined chunking, as a parallel windowed sum.

The classic Gear loop ``h = (h << 1) + G[b_t]`` discards bits past 31, so the
hash after byte t depends only on the last 32 bytes:

    h_t = sum_{i=0}^{31} G[b_{t-i}] << i        (mod 2^32)

Boundary candidates are positions where the top ``mask_bits`` of ``h_t`` are
zero. ``gear_hash`` here is the plain PyTorch version (int64 carriers masked
to 32 bits: torch on the CPU has no uint32 ``+`` or shifts); the kernel that
runs on the card is ``gear_compact`` in ``ops/kernels.py`` (``gear_mask`` in
the batch step).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

GEAR_WINDOW = 32
HALO_BYTES = GEAR_WINDOW  # a seq shard's halo: the left shard's last bytes of each row
_GEAR_SEED = 0x5EED_CDC1
_U32 = 0xFFFFFFFF


def splitmix64_stream(seed: int, n: int) -> np.ndarray:
    """Deterministic uint64 stream (splitmix64), stable across numpy versions:
    gear tables and fingerprint bases must agree between every gateway of a
    deployment (the cross-host dedup contract)."""
    mask = (1 << 64) - 1
    out = np.empty(n, dtype=np.uint64)
    x = seed & mask
    for i in range(n):
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        out[i] = z ^ (z >> 31)
    return out


GEAR_TABLE = (splitmix64_stream(_GEAR_SEED, 256) & np.uint64(_U32)).astype(np.uint32)


def gear_hash(data_u8: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[..., N] uint8 -> [..., N] int64 gear hashes in [0, 2^32), per row along
    the last axis with a zero prefix. ``table`` is ``GEAR_TABLE`` as an int64
    tensor on the data's device. Log-doubling: with S_k(t) = sum_{i<2^k}
    g_{t-i} << i, S_{k+1}(t) = S_k(t) + (S_k(t - 2^k) << 2^k)."""
    h = table[data_u8.long()]
    off = 1
    while off < GEAR_WINDOW:
        shifted = torch.zeros_like(h)
        shifted[..., off:] = h[..., :-off]
        h = (h + (shifted << off)) & _U32
        off <<= 1
    return h


def gear_hash_halo(rows: torch.Tensor, halo: Optional[torch.Tensor], table: torch.Tensor) -> torch.Tensor:
    """Plain per-shard gear hash with the left neighbour's halo (the
    counterpart of ``_gear_hash_halo`` in the JAX package's SPMD step):
    [B, n_local] uint8 rows of one seq shard and ``halo`` [B, HALO_BYTES]
    uint8 (the left shard's last bytes of each row; None for shard 0) ->
    [B, n_local] int64 hashes, equal to the unsharded ``gear_hash`` at these
    positions."""
    if halo is None:
        return gear_hash(rows, table)
    return gear_hash(torch.cat([halo, rows], dim=1), table)[:, HALO_BYTES:]


def boundary_candidate_mask(h: torch.Tensor, mask_bits: int) -> torch.Tensor:
    """Hashes in [0, 2^32) -> bool: True where the top mask_bits are zero."""
    return (h >> (32 - mask_bits)) == 0


def gear_hash_np(data: np.ndarray) -> np.ndarray:
    """Sequential numpy reference (the classic Gear loop)."""
    h = 0
    out = np.empty(len(data), dtype=np.uint32)
    table = GEAR_TABLE
    for t in range(len(data)):
        h = ((h << 1) + int(table[data[t]])) & _U32
        out[t] = h
    return out
