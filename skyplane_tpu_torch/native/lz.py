"""Python bindings for the native LZ codec (codec name ``native_lz``);
counterpart of ``skyplane_tpu/native/lz.py``."""

from __future__ import annotations

import ctypes

from skyplane_tpu_torch.chunk import MAX_CHUNK_BYTES
from skyplane_tpu_torch.exceptions import CodecException
from skyplane_tpu_torch.native import load_library


def compress(data: bytes) -> bytes:
    lib = load_library()
    cap = lib.skylz_max_compressed_size(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.skylz_compress(data, len(data), out, cap)
    if n == 0:
        raise CodecException("native_lz compression failed")
    return out.raw[:n]


def decompress(buf: bytes) -> bytes:
    if len(buf) < 11 or buf[:2] != b"SL" or buf[2] != 1:
        raise CodecException("native_lz: bad container header")
    raw_len = int.from_bytes(buf[3:11], "little")
    # raw_len is an untrusted u64 that sizes an allocation
    if raw_len > MAX_CHUNK_BYTES:
        raise CodecException(f"native_lz: container claims {raw_len} raw bytes (> {MAX_CHUNK_BYTES} cap)")
    lib = load_library()
    out = ctypes.create_string_buffer(max(raw_len, 1))
    n = lib.skylz_decompress(buf, len(buf), out, raw_len)
    if n != raw_len:
        raise CodecException(f"native_lz decompression failed ({n} != {raw_len})")
    return out.raw[:raw_len]


def checksum64(data: bytes, seed: int = 0) -> int:
    lib = load_library()
    return int(lib.skylz_checksum64(data, len(data), seed))
