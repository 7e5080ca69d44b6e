"""Arithmetic in GF(2^31 - 1) for the fingerprint lanes.

The TPU package splits every product into 16-bit limbs because the TPU has no
64-bit lanes. Here the plain versions carry values in int64 tensors, where
``(a * b) % M31`` is exact for a, b < 2^31, and a prefix sum of up to 2^23
terms below 2^31 (an 8 MiB bucket) stays below 2^54. The CUDA kernels use
the same helpers as ``__device__`` functions on u64 (``csrc/u32.cuh``).
Results are canonical in [0, M31): ``fold31`` maps M31 to 0.
"""

from __future__ import annotations

import numpy as np
import torch

M31 = (1 << 31) - 1  # 2147483647, Mersenne prime


def fold31(x: torch.Tensor) -> torch.Tensor:
    """Reduce non-negative int64 x < 2^62 into canonical [0, M31)."""
    x = (x >> 31) + (x & M31)
    x = (x >> 31) + (x & M31)
    return torch.where(x >= M31, x - M31, x)


def addmod31(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod M31 for canonical int64 a, b."""
    return fold31(a + b)


def mulmod31(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod M31 for int64 a, b < 2^31 (the product fits int64)."""
    return fold31(a * b)


def powmod31_table(base: int, n: int) -> np.ndarray:
    """Host-side table [base^0, ..., base^(n-1)] mod M31, built by size-doubling."""
    out = np.zeros(max(n, 1), dtype=np.uint64)
    out[0] = 1
    m = 1
    while m < n:
        step = out[:m] * ((out[m - 1] * base) % M31)  # base^m * base^i, fits u64
        take = min(m, n - m)
        out[m : m + take] = step[:take] % M31
        m *= 2
    return out[:n].astype(np.uint32)
