"""Host-facing codec registry for the chunk data path.

Same names and wire ids as the JAX package (``chunk.Codec``):

  none       — identity
  zstd       — zstandard frame (``zstandard`` imported at first use)
  tpu        — blockpack container (ops/blockpack.py)
  tpu_zstd   — blockpack, then zstd over the container
  native_lz  — the native LZ codec (native/lz.py, g++ build at first use)
  lz4        — LZ4 frames through the system liblz4 (utils/lz4ref.py)

Each codec's module is imported at first use.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, NamedTuple

from skyplane_tpu_torch.chunk import MAX_CHUNK_BYTES, Codec
from skyplane_tpu_torch.exceptions import CodecException


class CodecSpec(NamedTuple):
    name: str
    codec_id: Codec
    encode: Callable[[bytes], bytes]
    decode: Callable[[bytes], bytes]


def _zstd():
    import zstandard

    return zstandard


_codec_local = threading.local()


def zstd_level() -> int:
    """Encoder level for the zstd-backed codecs (SKYPLANE_TPU_ZSTD_LEVEL, default -2)."""
    return int(os.environ.get("SKYPLANE_TPU_ZSTD_LEVEL", "-2"))


def _encode_zstd(data: bytes) -> bytes:
    # compressor cached per worker thread; one zstd worker per core unless single-core
    level = zstd_level()
    comp = getattr(_codec_local, "zstd_compressor", None)
    if comp is None or getattr(_codec_local, "zstd_level", None) != level:
        try:
            usable = len(os.sched_getaffinity(0))
        except AttributeError:
            usable = os.cpu_count() or 1
        comp = _zstd().ZstdCompressor(level=level, threads=-1 if usable > 1 else 0)
        _codec_local.zstd_compressor = comp
        _codec_local.zstd_level = level
    return comp.compress(data)


def _decode_zstd(buf: bytes) -> bytes:
    # the frame's content size is untrusted and sizes the allocation: bound it first
    zstd = _zstd()
    try:
        params = zstd.get_frame_parameters(buf)
        if params.content_size in (zstd.CONTENTSIZE_UNKNOWN, zstd.CONTENTSIZE_ERROR):
            raise CodecException("zstd frame does not declare content size (rejected)")
        if params.content_size > MAX_CHUNK_BYTES:
            raise CodecException(f"zstd frame claims {params.content_size} bytes (> {MAX_CHUNK_BYTES} cap)")
        decomp = getattr(_codec_local, "zstd_decompressor", None)
        if decomp is None:
            decomp = _codec_local.zstd_decompressor = zstd.ZstdDecompressor()
        return decomp.decompress(buf)
    except zstd.ZstdError as e:
        raise CodecException(f"zstd decode failed (corrupt frame): {e}") from e


def _encode_tpu(data: bytes) -> bytes:
    from skyplane_tpu_torch.ops import blockpack

    return blockpack.encode_container(data)


def _decode_tpu(buf: bytes) -> bytes:
    from skyplane_tpu_torch.ops import blockpack

    return blockpack.decode_container(buf)


def _encode_tpu_zstd(data: bytes) -> bytes:
    return _encode_zstd(_encode_tpu(data))


def _decode_tpu_zstd(buf: bytes) -> bytes:
    return _decode_tpu(_decode_zstd(buf))


def _encode_native(data: bytes) -> bytes:
    from skyplane_tpu_torch.native import lz as native_lz

    return native_lz.compress(data)


def _decode_native(buf: bytes) -> bytes:
    from skyplane_tpu_torch.native import lz as native_lz

    return native_lz.decompress(buf)


def _encode_lz4(data: bytes) -> bytes:
    from skyplane_tpu_torch.utils import lz4ref

    return lz4ref.compress(data)


def _decode_lz4(buf: bytes) -> bytes:
    # an LZ4 frame need not declare its content size: cap the output at the
    # wire's chunk bound instead of trusting the frame
    from skyplane_tpu_torch.utils import lz4ref

    try:
        return lz4ref.decompress(buf, MAX_CHUNK_BYTES)
    except ValueError as e:
        raise CodecException(f"lz4 decode failed: {e}") from e


_REGISTRY: Dict[str, CodecSpec] = {
    "none": CodecSpec("none", Codec.NONE, lambda b: b, lambda b: b),
    "zstd": CodecSpec("zstd", Codec.ZSTD, _encode_zstd, _decode_zstd),
    "tpu": CodecSpec("tpu", Codec.TPU_BLOCK, _encode_tpu, _decode_tpu),
    "tpu_zstd": CodecSpec("tpu_zstd", Codec.TPU_BLOCK_ZSTD, _encode_tpu_zstd, _decode_tpu_zstd),
    "native_lz": CodecSpec("native_lz", Codec.NATIVE_LZ, _encode_native, _decode_native),
    # registered on every host: encode/decode raise where liblz4 is absent
    "lz4": CodecSpec("lz4", Codec.LZ4, _encode_lz4, _decode_lz4),
}

_BY_ID: Dict[int, CodecSpec] = {int(spec.codec_id): spec for spec in _REGISTRY.values()}


def get_codec(name: str) -> CodecSpec:
    if name not in _REGISTRY:
        raise CodecException(f"unknown codec {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_codec_by_id(codec_id: int) -> CodecSpec:
    if codec_id not in _BY_ID:
        raise CodecException(f"unknown codec id {codec_id}")
    return _BY_ID[codec_id]
