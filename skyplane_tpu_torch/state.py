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


@dataclass(frozen=True)
class DeviceTables:
    """The deterministic tables, resident on one device.

    ``gear``/``powers`` are int64 (the plain versions' carriers, values in
    [0, 2^32) and [0, M31)); ``gear_bits``/``powers_bits`` hold the same bits
    as int32, the uint32 operands of the CUDA kernels.
    """

    device: torch.device
    gear: torch.Tensor  # [256] int64
    powers: torch.Tensor  # [N_LANES, MAX_SEGMENT_BYTES] int64
    gear_bits: torch.Tensor  # [256] int32
    powers_bits: torch.Tensor  # [N_LANES, MAX_SEGMENT_BYTES] int32


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
