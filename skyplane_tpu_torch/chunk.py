"""Codec ids, chunk flags and the v5 wire header (counterpart of skyplane_tpu/chunk.py).

Only what the data path needs: the ``Codec`` ids and ``ChunkFlags`` bits
carried in every frame, ``MAX_CHUNK_BYTES`` and :class:`WireProtocolHeader`.
The ids and the 86-byte layout are the wire contract shared with JAX-package
gateways and must never be renumbered.

Frame layout (big-endian, 86 bytes):

  magic(8) version(4) chunk_id(16) data_len(8) raw_data_len(8)
  codec(1) flags(1) fingerprint(16) tenant(8) n_chunks_left_on_socket(8)
  hdr_crc(8)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from enum import IntEnum

from skyplane_tpu_torch.exceptions import SkyplaneTpuException

MAGIC = int.from_bytes(b"SKYTPU\x00\x05", "big")
WIRE_VERSION = 5
HEADER_LENGTH_BYTES = 86

# hard ceiling on per-chunk sizes accepted off the wire: data_len and
# raw_data_len are untrusted u64s that size allocations
MAX_CHUNK_BYTES = 8 << 30

DEFAULT_TENANT_ID = "0" * 16


class Codec(IntEnum):
    """Payload codec ids carried in the wire header."""

    NONE = 0
    ZSTD = 1
    TPU_BLOCK = 2  # block-suppress codec (ops/blockpack.py)
    TPU_BLOCK_ZSTD = 3  # block codec, literals further packed with zstd
    NATIVE_LZ = 4
    LZ4 = 5


class ChunkFlags(IntEnum):
    COMPRESSED = 1 << 0
    ENCRYPTED = 1 << 1
    RECIPE = 1 << 2  # payload is a dedup recipe, not raw bytes
    TRACED = 1 << 3


def _crc64(data: bytes) -> int:
    """64-bit header checksum (first 8 bytes of blake2b)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


@dataclass
class WireProtocolHeader:
    """Framed header preceding each chunk payload on a data socket."""

    chunk_id: str  # 128-bit hex
    data_len: int  # payload bytes on the wire (post codec)
    raw_data_len: int  # original chunk bytes (pre codec, pre recipe)
    codec: int = int(Codec.NONE)
    flags: int = 0
    fingerprint: str = "0" * 32  # 128-bit hex
    n_chunks_left_on_socket: int = 0
    tenant_id: str = DEFAULT_TENANT_ID  # 64-bit hex

    @property
    def is_recipe(self) -> bool:
        return bool(self.flags & ChunkFlags.RECIPE)

    def to_bytes(self) -> bytes:
        out = MAGIC.to_bytes(8, "big") + WIRE_VERSION.to_bytes(4, "big")
        chunk_id_bytes = bytes.fromhex(self.chunk_id)
        if len(chunk_id_bytes) != 16:
            raise SkyplaneTpuException(f"chunk_id must be 16 bytes hex, got {self.chunk_id!r}")
        out += chunk_id_bytes
        out += self.data_len.to_bytes(8, "big") + self.raw_data_len.to_bytes(8, "big")
        out += self.codec.to_bytes(1, "big") + self.flags.to_bytes(1, "big")
        fp = bytes.fromhex(self.fingerprint)
        if len(fp) != 16:
            raise SkyplaneTpuException(f"fingerprint must be 16 bytes hex, got {self.fingerprint!r}")
        tenant = bytes.fromhex(self.tenant_id)
        if len(tenant) != 8:
            raise SkyplaneTpuException(f"tenant_id must be 8 bytes hex, got {self.tenant_id!r}")
        out += fp + tenant + self.n_chunks_left_on_socket.to_bytes(8, "big")
        return out + _crc64(out).to_bytes(8, "big")

    @staticmethod
    def from_bytes(data: bytes) -> "WireProtocolHeader":
        if len(data) != HEADER_LENGTH_BYTES:
            raise SkyplaneTpuException(f"header must be {HEADER_LENGTH_BYTES} bytes, got {len(data)}")
        magic = int.from_bytes(data[0:8], "big")
        if magic != MAGIC:
            raise SkyplaneTpuException(f"bad magic {magic:#x}, expected {MAGIC:#x}")
        version = int.from_bytes(data[8:12], "big")
        if version != WIRE_VERSION:
            raise SkyplaneTpuException(f"unsupported wire version {version}, expected {WIRE_VERSION}")
        if int.from_bytes(data[78:86], "big") != _crc64(data[:78]):
            raise SkyplaneTpuException("wire header CRC mismatch")
        data_len = int.from_bytes(data[28:36], "big")
        raw_data_len = int.from_bytes(data[36:44], "big")
        if data_len > MAX_CHUNK_BYTES or raw_data_len > MAX_CHUNK_BYTES:
            raise SkyplaneTpuException(
                f"wire header claims {max(data_len, raw_data_len)} payload bytes (> {MAX_CHUNK_BYTES} cap)"
            )
        return WireProtocolHeader(
            chunk_id=data[12:28].hex(),
            data_len=data_len,
            raw_data_len=raw_data_len,
            codec=data[44],
            flags=data[45],
            fingerprint=data[46:62].hex(),
            tenant_id=data[62:70].hex(),
            n_chunks_left_on_socket=int.from_bytes(data[70:78], "big"),
        )
