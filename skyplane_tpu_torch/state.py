"""Carrying state across from the JAX package.

A gateway's dedup only works across hosts when every gateway of a deployment
uses the same gear table, lane bases and power tables (the cross-host
determinism contract). ``from_reference`` takes those arrays as the JAX
package exports them (numpy) and returns the port's device-resident tables,
refusing any array that differs from the port's own. ``index_from_reference``
seeds a sender index from ``(fingerprint, size)`` pairs, so a port sender can
carry on against a destination that a JAX sender warmed.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.fingerprint import LANE_BASES, _power_tables
from skyplane_tpu_torch.ops.gear import GEAR_TABLE
from skyplane_tpu_torch.ops.u32 import M31


@dataclass(frozen=True)
class DeviceTables:
    """The deterministic tables, resident on one device.

    ``gear``/``powers`` are int64 (the plain versions' carriers, values in
    [0, 2^32) and [0, M31)); ``gear_bits``/``powers_bits`` hold the same bits
    as int32, the uint32 operands of the CUDA kernels. ``word_limbs``,
    ``word_powers`` and ``inverse_powers`` are derived from the lane bases
    and powers for the fingerprint kernels' 64-byte words (see
    :func:`word_limbs_from_powers`, :func:`word_powers_from_powers` and
    :func:`inverse_powers_from_bases`).
    """

    device: torch.device
    gear: torch.Tensor  # [256] int64
    powers: torch.Tensor  # [N_LANES, MAX_SEGMENT_BYTES] int64
    gear_bits: torch.Tensor  # [256] int32
    powers_bits: torch.Tensor  # [N_LANES, MAX_SEGMENT_BYTES] int32
    word_limbs: torch.Tensor  # [WORD_BYTES, 4 * N_LANES] uint8
    word_powers: torch.Tensor  # [WORD_BYTES, MAX_SEGMENT_BYTES // WORD_BYTES, N_LANES] int32
    inverse_powers: torch.Tensor  # [WORD_BYTES, N_LANES] int32


WORD_BYTES = 64  # the fingerprint kernels' word: one row of their u8 matrix product
# the kernels' threads hold lanes 0, 2, 4, 6 or 1, 3, 5, 7 of a word
WORD_LANE_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def word_limbs_from_powers(powers: np.ndarray) -> np.ndarray:
    """[N_LANES, >= 64] powers -> [64, 4 * N_LANES] uint8: row k, column
    4l + q holds byte q (bits 8q..8q+7) of r_l^(63-k).

    A 64-byte word w at offset w0 then has W_l = sum_q (w @ B)[4l+q] << 8q =
    sum_k w_k r_l^(63-k), the word's lane-l polynomial; row k is byte k of the
    word, so B is read as the column-major operand of the kernels' product.
    """
    p = np.asarray(powers, dtype=np.uint32)[:, WORD_BYTES - 1 :: -1][:, :WORD_BYTES]  # [lanes, k] = r^(63-k)
    limbs = (p[:, :, None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF  # [lanes, k, q]
    return np.ascontiguousarray(limbs.transpose(1, 0, 2).reshape(WORD_BYTES, 4 * p.shape[0]).astype(np.uint8))


def word_powers_from_powers(powers: np.ndarray) -> np.ndarray:
    """[N_LANES, MAX] powers -> [64, MAX // 64, N_LANES] uint32: entry
    [x % 64, x // 64, i] is r_l^x for lane l = WORD_LANE_ORDER[i].

    The same powers, laid out for the fingerprint kernels' 64-byte words: a
    word's eight lanes share one 32-byte row (a thread reads its four as one
    16-byte load), and the words of one segment, whose power indices fall by
    64 a word, read consecutive rows. In the [N_LANES, MAX] layout each lane
    of each word is a sector of its own.
    """
    p = np.asarray(powers, dtype=np.uint32)
    lanes, n = p.shape
    p = p[list(WORD_LANE_ORDER)].reshape(lanes, n // WORD_BYTES, WORD_BYTES)  # [i, m, x0]
    return np.ascontiguousarray(p.transpose(2, 1, 0))


def inverse_powers_from_bases(bases) -> np.ndarray:
    """Lane bases -> [64, N_LANES] uint32: row d holds r_l^(-d) mod M31 for
    lane l = WORD_LANE_ORDER[i] (M31 is prime, so r^-1 = r^(M31-2)).

    A word cut by a segment end after its first m bytes adds those bytes as
    (W - W') * r^-(64-m), where W' is the product of the word with its first m
    bytes zeroed, so the tensor cores compute both pieces.
    """
    inv = [pow(int(r), M31 - 2, M31) for r in np.asarray(bases)[list(WORD_LANE_ORDER)]]
    out = np.ones((WORD_BYTES, len(inv)), dtype=np.uint64)
    for d in range(1, WORD_BYTES):
        out[d] = out[d - 1] * np.array(inv, dtype=np.uint64) % M31
    return out.astype(np.uint32)


_tables: Dict[str, DeviceTables] = {}
_tables_lock = threading.Lock()


def device_tables(device="cuda") -> DeviceTables:
    """The tables on ``device``, built on the host and uploaded once per device."""
    dev = resolve_device(device)
    with _tables_lock:
        t = _tables.get(str(dev))
        if t is None:
            gear = torch.from_numpy(GEAR_TABLE.astype(np.int64)).to(dev)
            powers = torch.from_numpy(_power_tables().astype(np.int64)).to(dev)
            t = _tables[str(dev)] = DeviceTables(
                dev,
                gear,
                powers,
                torch.from_numpy(GEAR_TABLE.view(np.int32).copy()).to(dev),
                torch.from_numpy(_power_tables().view(np.int32).copy()).to(dev),
                torch.from_numpy(word_limbs_from_powers(_power_tables())).to(dev),
                torch.from_numpy(word_powers_from_powers(_power_tables()).view(np.int32)).to(dev),
                torch.from_numpy(inverse_powers_from_bases(LANE_BASES).view(np.int32)).to(dev),
            )
        return t


REFERENCE_KEYS = ("GEAR_TABLE", "LANE_BASES", "power_tables")


def from_reference(arrays: Mapping[str, np.ndarray], device="cuda") -> DeviceTables:
    """Check the JAX package's ``GEAR_TABLE``, ``LANE_BASES`` and power tables
    (``_power_tables()``) against the port's and return the device tables.

    Raises ``ValueError`` if one is missing or differs: a gateway with other
    tables would fingerprint the same bytes differently and break every REF.
    """
    own = {"GEAR_TABLE": GEAR_TABLE, "LANE_BASES": LANE_BASES, "power_tables": _power_tables()}
    for key in REFERENCE_KEYS:
        if key not in arrays:
            raise ValueError(f"reference state lacks {key!r}")
        got = np.asarray(arrays[key])
        if got.shape != own[key].shape or not np.array_equal(got.astype(np.int64), own[key].astype(np.int64)):
            raise ValueError(f"reference {key} differs from the port's (cross-host dedup contract broken)")
    return device_tables(device)


def index_from_reference(entries: Iterable[Tuple[bytes, int]]):
    """A ``SenderDedupIndex`` holding ``(fp, size)`` pairs a JAX sender committed."""
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex

    index = SenderDedupIndex()
    for fp, size in entries:
        if len(fp) != 16:
            raise ValueError(f"fingerprint must be 16 bytes, got {len(fp)}")
        index.add(bytes(fp), int(size))
    return index
