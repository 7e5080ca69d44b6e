"""LZ4 frames through the system liblz4 (ctypes); counterpart of
``skyplane_tpu/utils/lz4ref.py``.

The ``lz4`` wire codec (``ops/codecs.py``) uses it: one-shot frames with
liblz4's default preferences, byte-compatible with the JAX package's frames
and with ``lz4.frame.compress(data)``.

``available()`` is False on hosts without liblz4.so.1. The codec stays
registered regardless: encode and decode raise RuntimeError at first use on
such hosts (the same lazy-failure contract as ``native_lz``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

#: LZ4 frame magic (little-endian 0x184D2204) — cheap wire sanity check.
LZ4F_MAGIC = b"\x04\x22\x4d\x18"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        name = ctypes.util.find_library("lz4") or "liblz4.so.1"
        try:
            lib = ctypes.CDLL(name)
            lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
            lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
            lib.LZ4F_compressFrame.restype = ctypes.c_size_t
            lib.LZ4F_compressFrame.argtypes = [
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_void_p,
            ]
            lib.LZ4F_isError.restype = ctypes.c_uint
            lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
            lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_createDecompressionContext.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
            lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
            lib.LZ4F_decompress.restype = ctypes.c_size_t
            lib.LZ4F_decompress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_void_p,  # src advances by byref offset, not a fresh c_char_p slice
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_void_p,
            ]
            lib.LZ4F_VERSION = 100  # LZ4F_getVersion is absent in older sos; 100 is the stable ABI version
            _lib = lib
        except (OSError, AttributeError):
            _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes) -> bytes:
    """One-shot LZ4 frame, default preferences — byte-compatible with the
    reference's ``lz4.frame.compress(data)`` defaults (level 0/fast)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available on this host")
    cap = lib.LZ4F_compressFrameBound(len(data), None)
    out = ctypes.create_string_buffer(cap)
    n = lib.LZ4F_compressFrame(out, cap, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError("LZ4F_compressFrame failed")
    return out.raw[:n]


#: scratch window for streaming decode — bounds per-call allocation no matter
#: how large the caller's cap is (an 8 GiB chunk cap must NOT mean an 8 GiB
#: zero-filled buffer per decode)
_DECODE_WINDOW = 1 << 20


def decompress(buf: bytes, max_out: int) -> bytes:
    """Streaming-context decompress of one frame into a grow-as-needed
    buffer, total output capped at ``max_out`` (the frame header's content
    size is optional in LZ4F, so the caller must bound the total — wire
    chunks use MAX_CHUNK_BYTES). Raises ValueError on corrupt, truncated, or
    cap-exceeding frames."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available on this host")
    ctx = ctypes.c_void_p()
    rc = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), lib.LZ4F_VERSION)
    if lib.LZ4F_isError(rc):
        raise RuntimeError("LZ4F_createDecompressionContext failed")
    try:
        window = ctypes.create_string_buffer(min(_DECODE_WINDOW, max(max_out, 1)))
        # one up-front copy of the input so the loop advances by pointer
        # offset — re-slicing buf[consumed:] per iteration would be O(n^2)
        # memcpy on the receiver's hot path
        src = (ctypes.c_char * len(buf)).from_buffer_copy(buf) if buf else (ctypes.c_char * 0)()
        out = bytearray()
        consumed = 0
        rc = 1  # LZ4F: nonzero = frame not yet complete
        while consumed < len(buf):
            dst_size = ctypes.c_size_t(len(window))
            src_size = ctypes.c_size_t(len(buf) - consumed)
            rc = lib.LZ4F_decompress(
                ctx,
                window,
                ctypes.byref(dst_size),
                ctypes.byref(src, consumed),
                ctypes.byref(src_size),
                None,
            )
            if lib.LZ4F_isError(rc):
                raise ValueError("corrupt LZ4 frame")
            out += ctypes.string_at(window, dst_size.value)
            consumed += src_size.value
            if len(out) > max_out:
                raise ValueError(f"LZ4 frame exceeds the {max_out}-byte output cap")
            if rc == 0:  # frame complete
                break
            if dst_size.value == 0 and src_size.value == 0:
                raise ValueError("LZ4 frame makes no progress (corrupt or hostile)")
        if rc != 0:
            # input exhausted mid-frame: a truncated wire chunk must surface
            # as an error, never as silently-shortened plaintext
            raise ValueError("truncated LZ4 frame")
        if consumed != len(buf):
            # bytes after a complete frame = framing corruption (same strict
            # whole-buffer contract as the zstd decoder)
            raise ValueError(f"{len(buf) - consumed} trailing bytes after LZ4 frame")
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)
