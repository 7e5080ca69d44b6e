"""Block-suppress codec container (the ``tpu`` codecs' wire format).

A chunk is split into fixed-size blocks, each tagged zero (emits nothing),
constant (emits 1 byte) or literal (emits the block); literals are compacted
in stream order. Container layout (little-endian):

  magic 0xB1 0x0C | ver(1) | block_log2(1) | n_raw_bytes(8) | n_lit_bytes(8)
  | packed 2-bit tags (ceil(n_blocks/4) bytes) | literal bytes

The container is encoded and decoded on the host by the native library's
single-pass loops (``native/datapath.py``) when it is available, with numpy
(``ops/host_fallback.py``) otherwise; both are byte-identical to the JAX
package's native, numpy and device paths. ``encode_device`` is the batch
step's device encode (the ``blockpack_encode`` CUDA kernel on a card, its
plain version on the CPU); ``decode_device``, its inverse, is plain PyTorch.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from skyplane_tpu_torch.exceptions import CodecException

MAGIC = b"\xb1\x0c"
VERSION = 1
DEFAULT_BLOCK_BYTES = 512

TAG_ZERO = 0
TAG_CONST = 1
TAG_LITERAL = 2

_HEAD = struct.Struct("<BBQQ")


def encode_device(data: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES):
    """[B, N] uint8 (N divisible by block_bytes) -> (tags [B, N/block_bytes]
    uint8, literals [B, N] uint8, n_lit [B] int32): the reference's
    ``encode_device`` for each row.

    ``literals`` holds the first ``n_lit`` valid bytes of each row; the tail
    is zero. On a CUDA tensor this launches the ``blockpack_encode`` kernel.
    """
    from skyplane_tpu_torch.ops import kernels

    return kernels.blockpack_encode(data, block_bytes)


def decode_device(tags: torch.Tensor, literals: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES) -> torch.Tensor:
    """Inverse of ``encode_device``: (tags [..., NB], literals [..., L]) ->
    [..., NB * block_bytes] uint8. Out-of-range literal indices (a zero
    block after the last kept byte) are clamped, as the reference's gather
    clamps them; they only ever feed zero blocks."""
    kept = torch.where(tags == TAG_LITERAL, block_bytes, torch.where(tags == TAG_CONST, 1, 0)).long()
    offsets = torch.cumsum(kept, -1) - kept
    col = torch.arange(block_bytes, device=tags.device)
    index = torch.where((tags == TAG_LITERAL)[..., None], offsets[..., None] + col, offsets[..., None])
    shape = tags.shape[:-1] + (tags.shape[-1] * block_bytes,)
    if literals.shape[-1] == 0:
        return torch.zeros(shape, dtype=torch.uint8, device=tags.device)
    index = index.reshape(shape).clamp(max=literals.shape[-1] - 1)
    gathered = literals.gather(-1, index).view(tags.shape + (block_bytes,))
    out = torch.where((tags == TAG_ZERO)[..., None], torch.zeros_like(gathered), gathered)
    return out.reshape(shape)


def _pack_tags(tags: np.ndarray) -> bytes:
    """2-bit pack tags, 4 per byte."""
    pad = (-len(tags)) % 4
    t = np.concatenate([tags, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    packed = t[:, 0] | (t[:, 1] << 2) | (t[:, 2] << 4) | (t[:, 3] << 6)
    return packed.astype(np.uint8).tobytes()


def _unpack_tags(buf: bytes, n_blocks: int) -> np.ndarray:
    packed = np.frombuffer(buf, dtype=np.uint8)
    t = np.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3], axis=1).reshape(-1)
    return t[:n_blocks]


def encode_container(data: bytes, block_bytes: int = DEFAULT_BLOCK_BYTES) -> bytes:
    """Raw bytes -> blockpack container."""
    from skyplane_tpu_torch.native import datapath as native_dp

    n_raw = len(data)
    block_log2 = int(block_bytes).bit_length() - 1
    if (1 << block_log2) != block_bytes:
        raise CodecException(f"block_bytes must be a power of two, got {block_bytes}")
    if n_raw == 0:
        return MAGIC + _HEAD.pack(VERSION, block_log2, 0, 0)
    pad = (-n_raw) % block_bytes
    arr = np.frombuffer(data, np.uint8)
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    if native_dp.available():
        tags, lit, n_lit = native_dp.blockpack_encode(arr, block_bytes)
    else:
        from skyplane_tpu_torch.ops.host_fallback import blockpack_encode_host

        tags, lit, n_lit = blockpack_encode_host(arr, block_bytes)
    return MAGIC + _HEAD.pack(VERSION, block_log2, n_raw, n_lit) + _pack_tags(tags) + lit.tobytes()


def decode_container(buf: bytes) -> bytes:
    """Blockpack container -> raw bytes."""
    from skyplane_tpu_torch.native import datapath as native_dp

    head_len = 2 + _HEAD.size
    if len(buf) < 2 or buf[:2] != MAGIC:
        raise CodecException("not a blockpack container (bad magic)")
    if len(buf) < head_len:
        raise CodecException("truncated blockpack header")
    ver, block_log2, n_raw, n_lit = _HEAD.unpack_from(buf, 2)
    if block_log2 > 30 or n_raw > (1 << 40) or n_lit > len(buf):
        raise CodecException("implausible blockpack header fields (corrupted container)")
    if ver != VERSION:
        raise CodecException(f"unsupported blockpack version {ver}")
    if n_raw == 0:
        return b""
    block_bytes = 1 << block_log2
    n_blocks = (n_raw + block_bytes - 1) // block_bytes
    tag_bytes = (n_blocks + 3) // 4
    if len(buf) < head_len + tag_bytes:
        raise CodecException("truncated blockpack container (tag region)")
    tags = _unpack_tags(buf[head_len : head_len + tag_bytes], n_blocks)
    literals = np.frombuffer(buf[head_len + tag_bytes : head_len + tag_bytes + n_lit], np.uint8)
    if len(literals) != n_lit:
        raise CodecException("truncated blockpack container")
    if native_dp.available():
        out = native_dp.blockpack_decode(tags, literals, block_bytes)
    else:
        from skyplane_tpu_torch.ops.host_fallback import blockpack_decode_host

        out = blockpack_decode_host(tags, literals, block_bytes)
    return out[:n_raw].tobytes()
