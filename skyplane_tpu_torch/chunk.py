"""Chunk model and framed wire protocol (v5).

This is the shared kernel of the data plane: every byte that crosses a WAN
socket is framed by :class:`WireProtocolHeader`, and every unit of work queued
through gateway operator DAGs is a :class:`ChunkRequest`.

Reference parity (skyplane/chunk.py:9-167): ``Chunk``/``ChunkRequest``/
``ChunkState``/``WireProtocolHeader`` with the same lifecycle semantics. The
wire protocol here is **version 5** and extends the reference's 53-byte v3
frame with data-path and multi-tenancy fields (byte-identical to the JAX
package's, so the two packages' gateways interoperate):

  * ``codec``        — codec id used on the payload (none / zstd / block
                       codec / block+zstd hybrid), so receivers dispatch the
                       right decode kernel without out-of-band config.
  * ``flags``        — bitfield: compressed / encrypted / recipe. ``recipe``
                       marks a dedup recipe payload (fingerprint list +
                       literal ranges) rather than raw chunk bytes.
  * ``fingerprint``  — 128-bit content fingerprint of the *raw* chunk, used
                       for end-to-end integrity and as the dedup index key.
  * ``tenant_id``    — 64-bit tenant tag minted at the API layer (v5): the
                       receiver attributes decode bytes, dedup-index bytes,
                       and NACKs to the owning tenant so one gateway fleet
                       can serve many concurrent jobs with per-tenant
                       quotas and metrics (skyplane_tpu/tenancy/).

Frame layout (big-endian, 86 bytes):

  magic(8) version(4) chunk_id(16) data_len(8) raw_data_len(8)
  codec(1) flags(1) fingerprint(16) tenant(8) n_chunks_left_on_socket(8)
  hdr_crc(8)
"""

from __future__ import annotations

import hashlib
import re
import socket
from dataclasses import dataclass, field, asdict
from enum import Enum, IntEnum, auto
from functools import total_ordering
from typing import Optional

from skyplane_tpu_torch.exceptions import SkyplaneTpuException

MAGIC = int.from_bytes(b"SKYTPU\x00\x05", "big")
WIRE_VERSION = 5
HEADER_LENGTH_BYTES = 86

# Hard ceiling on per-chunk sizes accepted off the wire or the control API.
# data_len/raw_data_len are attacker-controlled u64s that feed straight into
# bytearray()/codec allocations — a hostile frame must not be able to request
# an arbitrarily large allocation (and the resulting MemoryError must not kill
# the daemon). 8 GiB is ~128x the default 64 MiB chunk size.
MAX_CHUNK_BYTES = 8 << 30

_CHUNK_ID_RE = re.compile(r"^[0-9a-f]{32}$")

# Tenant ids are 64-bit tags rendered as 16 lowercase hex chars, minted at the
# API layer (tenancy.mint_tenant_id). The all-zeros tenant is the implicit
# single-tenant default: legacy clients that never set one land there.
DEFAULT_TENANT_ID = "0" * 16
_TENANT_ID_RE = re.compile(r"^[0-9a-f]{16}$")


def validate_chunk_id(chunk_id: str) -> str:
    """chunk_id is joined into filesystem paths (<chunk_dir>/<id>.chunk); ids
    arriving via the control API are arbitrary strings, so anything but the
    canonical 32-hex uuid form (e.g. '../../x') is rejected before use."""
    if not isinstance(chunk_id, str) or not _CHUNK_ID_RE.match(chunk_id):
        raise SkyplaneTpuException(f"invalid chunk_id {chunk_id!r}: must be 32 lowercase hex chars")
    return chunk_id


def validate_tenant_id(tenant_id: Optional[str]) -> str:
    """Tenant ids arrive via the control API and are used as metric labels and
    accounting keys; anything but the canonical 16-hex form is rejected.
    None/empty maps to the single-tenant default."""
    if tenant_id is None or tenant_id == "":
        return DEFAULT_TENANT_ID
    if not isinstance(tenant_id, str) or not _TENANT_ID_RE.match(tenant_id):
        raise SkyplaneTpuException(f"invalid tenant_id {tenant_id!r}: must be 16 lowercase hex chars")
    return tenant_id


class Codec(IntEnum):
    """Payload codec ids carried in the wire header."""

    NONE = 0
    ZSTD = 1  # CPU zstandard (the LZ4-equivalent CPU reference path)
    TPU_BLOCK = 2  # block-suppress codec (ops/blockpack.py); the id keeps its wire name
    TPU_BLOCK_ZSTD = 3  # block codec, literals further packed with zstd
    NATIVE_LZ = 4  # native C++ LZ codec (native/)
    LZ4 = 5  # real LZ4 frames via system liblz4 (reference's wire codec)


class ChunkFlags(IntEnum):
    COMPRESSED = 1 << 0
    ENCRYPTED = 1 << 1
    RECIPE = 1 << 2  # payload is a dedup recipe, not raw bytes
    TRACED = 1 << 3  # sender sampled this chunk for tracing; receiver spans follow suit


@total_ordering
class ChunkState(Enum):
    """Chunk lifecycle at a gateway (reference: skyplane/chunk.py:79-92)."""

    registered = auto()
    in_progress = auto()
    failed = auto()
    queued = auto()
    complete = auto()

    @staticmethod
    def from_str(s: str) -> "ChunkState":
        return ChunkState[s.lower()]

    def __lt__(self, other: "ChunkState") -> bool:
        return self.value < other.value

    def to_short_str(self) -> str:
        return self.name


@dataclass
class Chunk:
    """A contiguous byte range of a source object (reference: skyplane/chunk.py:9-43)."""

    src_key: str
    dest_key: str
    chunk_id: str  # uuid4().hex
    chunk_length_bytes: int
    partition_id: str = "default"
    mime_type: Optional[str] = None
    # multicast with differing destination prefixes: per-region destination
    # keys; write operators prefer dest_keys[their region] over dest_key
    dest_keys: Optional[dict] = None  # region_tag -> key

    # multipart upload bookkeeping
    file_offset_bytes: Optional[int] = None
    part_number: Optional[int] = None
    upload_id: Optional[str] = None
    multi_part: Optional[bool] = False

    # integrity: md5 for object-store Content-MD5; fingerprint for wire/dedup
    md5_hash: Optional[str] = None  # hex
    fingerprint: Optional[str] = None  # 32 hex chars (128-bit)

    # the sender's deterministic trace-sampling decision, stamped at chunk
    # pre-registration so destination-side operators past the receiver
    # (write_local, obj-store writes) force their spans for the SAME chunks
    # even when the two gateways run different sample rates — the wire
    # header's TRACED flag covers only the socket hop (docs/observability.md)
    traced: Optional[bool] = False

    # overlay hop index of the gateway this request was registered AT: 0 at
    # the original source, incremented by every sender's pre-registration
    # POST, so each hop's spans carry their position on the path and a merged
    # fleet timeline orders gateways source → relay → destination
    # (docs/observability.md multi-hop stitching)
    hop: Optional[int] = 0

    # owning tenant (16 hex chars, minted at the API layer); rides the wire
    # header so every gateway on the path attributes this chunk's resource
    # use to the right tenant (docs/multitenancy.md). None = default tenant.
    tenant_id: Optional[str] = None

    def to_wire_header(
        self,
        n_chunks_left_on_socket: int,
        wire_length: int,
        raw_wire_length: int,
        codec: Codec = Codec.NONE,
        is_compressed: bool = False,
        is_encrypted: bool = False,
        is_recipe: bool = False,
    ) -> "WireProtocolHeader":
        flags = 0
        if is_compressed:
            flags |= ChunkFlags.COMPRESSED
        if is_encrypted:
            flags |= ChunkFlags.ENCRYPTED
        if is_recipe:
            flags |= ChunkFlags.RECIPE
        return WireProtocolHeader(
            chunk_id=self.chunk_id,
            data_len=wire_length,
            raw_data_len=raw_wire_length,
            codec=int(codec),
            flags=flags,
            fingerprint=self.fingerprint or "0" * 32,
            n_chunks_left_on_socket=n_chunks_left_on_socket,
            tenant_id=self.tenant_id or DEFAULT_TENANT_ID,
        )

    def as_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Chunk":
        return Chunk(**d)


@dataclass
class ChunkRequest:
    """A chunk plus its transfer context (reference: skyplane/chunk.py:47-76)."""

    chunk: Chunk
    src_region: Optional[str] = None
    dst_region: Optional[str] = None
    src_type: Optional[str] = None  # object_store | gen_data | local
    dst_type: Optional[str] = None  # object_store | save_local
    src_random_size_mb: Optional[int] = None
    src_object_store_bucket: Optional[str] = None
    dst_object_store_bucket: Optional[str] = None

    def as_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ChunkRequest":
        d = dict(d)
        d["chunk"] = Chunk.from_dict(d["chunk"])
        validate_chunk_id(d["chunk"].chunk_id)
        return ChunkRequest(**d)


def _crc64(data: bytes) -> int:
    """Cheap 64-bit header checksum (first 8 bytes of blake2b)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


@dataclass
class WireProtocolHeader:
    """Framed header preceding each chunk payload on a data socket.

    Reference parity: skyplane/chunk.py:96-167 (v3, 53 bytes). v4 added codec,
    flags, fingerprint and a header CRC; v5 adds the 64-bit tenant tag so
    multi-tenant gateways attribute every frame (docs/multitenancy.md). See
    the module docstring for the layout.
    """

    chunk_id: str  # 128-bit uuid4 hex
    data_len: int  # payload bytes on the wire (post codec/encrypt)
    raw_data_len: int  # original chunk bytes (pre codec, pre recipe)
    codec: int = int(Codec.NONE)
    flags: int = 0
    fingerprint: str = "0" * 32  # 128-bit hex
    n_chunks_left_on_socket: int = 0
    tenant_id: str = DEFAULT_TENANT_ID  # 64-bit hex tenant tag (v5)

    @staticmethod
    def magic_hex() -> int:
        return MAGIC

    @staticmethod
    def protocol_version() -> int:
        return WIRE_VERSION

    @staticmethod
    def length_bytes() -> int:
        return HEADER_LENGTH_BYTES

    @property
    def is_compressed(self) -> bool:
        return bool(self.flags & ChunkFlags.COMPRESSED)

    @property
    def is_encrypted(self) -> bool:
        return bool(self.flags & ChunkFlags.ENCRYPTED)

    @property
    def is_recipe(self) -> bool:
        return bool(self.flags & ChunkFlags.RECIPE)

    @property
    def is_traced(self) -> bool:
        return bool(self.flags & ChunkFlags.TRACED)

    def to_bytes(self) -> bytes:
        out = b""
        out += MAGIC.to_bytes(8, "big")
        out += WIRE_VERSION.to_bytes(4, "big")
        chunk_id_bytes = bytes.fromhex(self.chunk_id)
        if len(chunk_id_bytes) != 16:
            raise SkyplaneTpuException(f"chunk_id must be 16 bytes hex, got {self.chunk_id!r}")
        out += chunk_id_bytes
        out += self.data_len.to_bytes(8, "big")
        out += self.raw_data_len.to_bytes(8, "big")
        out += self.codec.to_bytes(1, "big")
        out += self.flags.to_bytes(1, "big")
        fp = bytes.fromhex(self.fingerprint)
        if len(fp) != 16:
            raise SkyplaneTpuException(f"fingerprint must be 16 bytes hex, got {self.fingerprint!r}")
        out += fp
        tenant = bytes.fromhex(self.tenant_id)
        if len(tenant) != 8:
            raise SkyplaneTpuException(f"tenant_id must be 8 bytes hex, got {self.tenant_id!r}")
        out += tenant
        out += self.n_chunks_left_on_socket.to_bytes(8, "big")
        out += _crc64(out).to_bytes(8, "big")
        assert len(out) == HEADER_LENGTH_BYTES
        return out

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
        crc = int.from_bytes(data[78:86], "big")
        if crc != _crc64(data[:78]):
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

    @staticmethod
    def from_socket(sock: socket.socket) -> "WireProtocolHeader":
        """Blocking read of one header from a socket (reference: skyplane/chunk.py:157-164)."""
        num_bytes = HEADER_LENGTH_BYTES
        buf = bytearray()
        while len(buf) < num_bytes:
            got = sock.recv(num_bytes - len(buf))
            if not got:
                raise ConnectionError("socket closed while reading wire header")
            buf.extend(got)
        return WireProtocolHeader.from_bytes(bytes(buf))

    def to_socket(self, sock: socket.socket) -> None:
        sock.sendall(self.to_bytes())
