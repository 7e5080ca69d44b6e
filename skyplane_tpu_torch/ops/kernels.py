"""The hand-written CUDA kernels of the sender data path, their plain
PyTorch versions, their launch counts, and the build and loader.

Counterpart of ``skyplane_tpu/ops/pallas_kernels.py``. Two kernels carry
the per-chunk sender path (sources in ``skyplane_tpu_torch/csrc/``):

- ``gear_compact`` (K-AB, ``csrc/gear_compact.cu``) is all of call A in one
  pass: it replaces the Pallas gear windowed sum (``pallas_kernels.py``
  ``gear_windowed_sum_pallas``) with the table gather and the candidate
  mask around it, and the XLA compaction (``fused_cdc.py``
  ``_candidates_impl``). Bound by bytes: one conflict-free table read per
  byte, and the ordered compaction by a decoupled look-back in the same
  pass, so neither the mask nor the tile counts reach device memory. Its
  plain version is the two halves K-A and K-B, ``gear_candidates_plain``
  then ``compact_candidates_plain``.
- ``segment_fp`` (K-C, ``csrc/segment_fp.cu``) replaces call B (``fused_cdc.py``
  ``_fp_body`` + ``fingerprint.py`` ``segment_fingerprint_cumsum``). Bound by
  bytes: the lanes of each 64-byte word come from an integer tensor-core
  product with ``DeviceTables.word_limbs`` (``csrc/lane_poly.cuh``), and
  only words that an end or the power clamp cuts go byte by byte.

Three more carry the fused batch step ``datapath_step`` (``ops/pipeline.py``):

- ``gear_mask`` (K-A', ``csrc/gear_mask.cu``): the same hash, and the whole
  [B, N] candidate mask, one byte per position. Bound by bytes.
- ``segment_fp_fixed`` (K-D, ``csrc/segment_fp_fixed.cu``) replaces the
  Pallas fixed-stride fingerprint (``pallas_kernels.py``
  ``segment_fp_fixed_pallas``) and its XLA fall-through, for every stride
  that divides N. Bound by bytes: strides that are a multiple of 64 take
  the same word product as K-C; other strides go byte by byte.
- ``blockpack_encode`` (K-E, ``csrc/blockpack_encode.cu``) replaces the XLA
  ``blockpack.py`` ``encode_device``. Bound by bytes: one pass that reads
  each tile once into shared memory (a bulk copy), finds its offset by a
  decoupled look-back, and writes its literal run and a mirrored share of
  the zero tail once each with 16-byte stores.

Each source file says how its design answers its bound. Each wrapper checks
its operands, then runs the plain version when the batch lies on the CPU and
launches the kernel when it lies on a CUDA device; a failed launch raises,
there is no fallback. ``launch_counts()`` counts kernel launches only.

Build: each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/skyplane_tpu_torch/`` (named by
a hash of its sources and flags), at first use or by :func:`build`, which
starts one ``nvcc`` per source at once. The libraries are loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``, and each C
function returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from skyplane_tpu_torch.native import BUILD_DIR
from skyplane_tpu_torch.ops.blockpack import TAG_CONST, TAG_LITERAL, TAG_ZERO
from skyplane_tpu_torch.ops.fingerprint import (
    MAX_SEGMENT_BYTES,
    N_LANES,
    segment_fingerprint_cumsum,
    segment_fingerprint_device,
)
from skyplane_tpu_torch.ops.gear import boundary_candidate_mask, gear_hash

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

GEAR_TILE = 8192  # bytes per K-AB sub-tile and per K-A' block: rows are a multiple of it
GEAR_CHUNK = 1 << 18  # bytes per K-AB chunk (its ticket and look-back unit, one status word each)
FP_TILE = 4096  # K-C's bucket unit (its blocks take 16 KiB tiles, the last one cut at the bucket)
FP_WORD = 64  # K-D takes its word path for strides that are a multiple of this
FP_FIXED_STEP = 256  # columns per K-D byte-path block step (256 threads x 1 byte)
FP_FIXED_BLOCKS = 2048  # K-D's byte path splits segments over blocks until about this many run
BLOCKPACK_TILE = 24576  # K-E's T0: the most bytes of a tile (its kTile), one status word each
MAX_FIXED_SEG = 1 << 24  # the reference's u32 limb sums wrap past this segment length
MAX_ROWS = 65535  # grid y limit

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> (source, C argument types after the name's pointers)
_KERNELS = {
    "gear_compact": ("gear_compact.cu", [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P]),
    "segment_fp": ("segment_fp.cu", [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]),
    "gear_mask": ("gear_mask.cu", [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P]),
    "segment_fp_fixed": ("segment_fp_fixed.cu", [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _LL, _I, _I, _I, _P]),
    "blockpack_encode": ("blockpack_encode.cu", [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches = {name: 0 for name in _KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset (plain runs never count)."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


# ---- build and load ----


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> Path:
    """Where kernel ``name`` is built: keyed by its source, the headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / _KERNELS[name][0]] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the kernels not yet built, one ``nvcc`` per source, all started
    together. Returns seconds per kernel (0.0 when already built); raises
    ``RuntimeError`` with the compiler's output when one fails. ``-Xptxas -v``
    output (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    names = list(_KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", f"-I{CSRC}", "-o", str(tmp), str(CSRC / _KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"skyt_{name}")
            fn.argtypes = _KERNELS[name][1]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry on the current stream of ``device``;
    raise on a CUDA error, count the launch on success."""
    fn = getattr(_lib(name), f"skyt_{name}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    with _lock:
        _launches[name] += 1


# ---- operand checks ----


def _check_batch(batch: torch.Tensor) -> Tuple[int, int]:
    b, bucket = _check_rows(batch)
    if bucket % GEAR_TILE:
        raise ValueError(f"bucket {bucket} must be a positive multiple of {GEAR_TILE} below 2^31")
    if batch.device.type == "cuda" and batch.data_ptr() % 16:
        raise ValueError("batch must be 16-byte aligned")
    return b, bucket


def _check_rows(batch: torch.Tensor) -> Tuple[int, int]:
    """A [B, N] uint8 batch of any row length (the batch step's kernels)."""
    if batch.dtype != torch.uint8 or batch.dim() != 2 or not batch.is_contiguous():
        raise ValueError(f"batch must be a contiguous [B, N] uint8 tensor, got {batch.dtype} {tuple(batch.shape)}")
    b, n = batch.shape
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"batch rows {b} outside [1, {MAX_ROWS}]")
    if not 0 < n < (1 << 31):
        raise ValueError(f"row length {n} outside [1, 2^31)")
    return b, n


def _check_operand(t: torch.Tensor, shape, dtype, device, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


# ---- K-AB: call A in one pass (gear hash, candidate test, ordered compaction) ----


def gear_candidates_plain(batch: torch.Tensor, lens: torch.Tensor, tables, mask_bits: int):
    """The first half of K-AB's plain version: [B, bucket] uint8 + lens [B]
    int32 -> (mask [B, bucket/32] int32, counts [B, bucket/GEAR_TILE] int32).

    Bit k of mask word w is set where position p = 32w + k is a boundary
    candidate (top ``mask_bits`` of the gear hash zero) and p < lens[row];
    counts[row, t] is the number of candidates in tile t (GEAR_TILE bytes).
    """
    b, bucket = batch.shape
    h = gear_hash(batch, tables.gear)
    iota = torch.arange(bucket, device=batch.device)
    valid = boundary_candidate_mask(h, mask_bits) & (iota[None, :] < lens.long()[:, None])
    shifts = torch.arange(32, device=batch.device)
    words = (valid.view(b, bucket // 32, 32).long() << shifts).sum(-1)  # distinct bits: sum == or
    counts = valid.view(b, bucket // GEAR_TILE, GEAR_TILE).sum(-1, dtype=torch.int32)
    return words.to(torch.int32), counts


def compact_candidates_plain(mask: torch.Tensor, bucket: int, cap: int) -> torch.Tensor:
    """The second half of K-AB's plain version: the mask words -> packed
    [B, cap+1] int32 (the scatter form of ``_candidates_impl``)."""
    b, w = mask.shape
    shifts = torch.arange(32, device=mask.device)
    valid = (((mask.long() & 0xFFFFFFFF)[:, :, None] >> shifts) & 1).bool().view(b, w * 32)
    n_cand = valid.sum(-1)
    pos = torch.cumsum(valid, -1) - 1
    scatter_to = torch.where(valid & (pos < cap), pos, torch.full_like(pos, cap))  # cap -> overwritten below
    out = torch.full((b, cap + 1), bucket, dtype=torch.int64, device=mask.device)
    out.scatter_(1, scatter_to, torch.arange(w * 32, device=mask.device).expand(b, -1).contiguous())
    out[:, cap] = n_cand
    return out.to(torch.int32)


def gear_compact_plain(batch: torch.Tensor, lens: torch.Tensor, tables, mask_bits: int, cap: int) -> torch.Tensor:
    """Plain version of K-AB: the candidate mask, then its ordered compaction."""
    mask, _ = gear_candidates_plain(batch, lens, tables, mask_bits)
    return compact_candidates_plain(mask, batch.shape[1], cap)


def gear_compact(batch: torch.Tensor, lens: torch.Tensor, tables, mask_bits: int, cap: int) -> torch.Tensor:
    """[B, bucket] uint8 + lens [B] int32 -> packed [B, cap+1] int32: the first
    ``cap`` boundary candidates of each row (positions p < lens[row] where
    the top ``mask_bits`` of the gear hash are zero) in ascending order,
    padded with ``bucket``, and the true candidate count (even past ``cap``)
    in column ``cap``."""
    b, bucket = _check_batch(batch)
    if not 1 <= mask_bits <= 31:
        raise ValueError(f"mask_bits {mask_bits} outside [1, 31]")
    if not 1 <= cap < (1 << 31) - 1:
        raise ValueError(f"cap {cap} outside [1, 2^31 - 1)")
    _check_operand(lens, (b,), torch.int32, batch.device, "lens")
    if batch.device.type == "cpu":
        return gear_compact_plain(batch, lens, tables, mask_bits, cap)
    out = torch.empty((b, cap + 1), dtype=torch.int32, device=batch.device)
    scratch = torch.empty((1 + b * -(-bucket // GEAR_CHUNK),), dtype=torch.int64, device=batch.device)  # ticket, status
    _launch(
        "gear_compact", batch.device, batch.data_ptr(), lens.data_ptr(), tables.gear_bits.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), bucket, b, mask_bits, cap,
    )
    return out


# ---- K-C: variable-segment fingerprints ----


def segment_fp_plain(batch: torch.Tensor, ends_slots: torch.Tensor, tables) -> torch.Tensor:
    """Plain version of K-C: ``_fp_body`` + ``segment_fingerprint_cumsum``."""
    b, bucket = batch.shape
    n_slots = ends_slots.shape[1]
    ends = ends_slots.long()
    dev = batch.device
    # a byte at an end offset belongs to the NEXT segment; ends == bucket drop out
    marks = torch.zeros((b, bucket + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, ends.clamp(0, bucket), torch.ones_like(ends))
    seg_ids = torch.cumsum(marks[:, :bucket], -1)
    seg_end = ends.gather(1, seg_ids.clamp(max=n_slots - 1))
    rev_pos = (seg_end - 1 - torch.arange(bucket, device=dev)).clamp(0, MAX_SEGMENT_BYTES - 1)
    starts = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev), ends[:, :-1]], dim=1)
    c = ends.clamp(0, bucket)
    s = starts.clamp(0, bucket)
    lanes = segment_fingerprint_cumsum(batch, rev_pos, torch.minimum(s, c), c, tables.powers)
    return lanes.to(torch.int32)


def segment_fp(batch: torch.Tensor, ends_slots: torch.Tensor, tables) -> torch.Tensor:
    """[B, bucket] uint8 + [B, n_slots] int32 segment ends -> [B, n_slots, 8]
    int32 lanes in [0, M31) (uint32 values).

    ``ends_slots`` rows: ascending real ends (the last is the chunk length),
    then one ``bucket`` end when the chunk is shorter than the bucket, then
    ``bucket`` sentinels, whose slots come out 0.
    """
    b, bucket = _check_batch(batch)
    if bucket % FP_TILE:
        raise ValueError(f"bucket {bucket} must be a multiple of {FP_TILE}")
    if ends_slots.dim() != 2 or ends_slots.shape[0] != b or ends_slots.shape[1] < 1:
        raise ValueError(f"ends_slots must be [B={b}, n_slots], got {tuple(ends_slots.shape)}")
    n_slots = ends_slots.shape[1]
    _check_operand(ends_slots, (b, n_slots), torch.int32, batch.device, "ends_slots")
    if batch.device.type == "cpu":
        return segment_fp_plain(batch, ends_slots, tables)
    acc = torch.empty((b, n_slots, N_LANES), dtype=torch.int64, device=batch.device)  # u64 scratch
    out = torch.empty((b, n_slots, N_LANES), dtype=torch.int32, device=batch.device)
    _launch(
        "segment_fp", batch.device, batch.data_ptr(), ends_slots.data_ptr(), tables.word_limbs.data_ptr(),
        tables.word_powers.data_ptr(), tables.inverse_powers.data_ptr(), acc.data_ptr(), out.data_ptr(), bucket, b,
        n_slots, MAX_SEGMENT_BYTES,
    )
    return out


# ---- K-A': the full-width candidate mask (K-A's byte-mask mode) ----


def gear_mask_plain(batch: torch.Tensor, tables, mask_bits: int) -> torch.Tensor:
    """Plain version of K-A': ``boundary_candidate_mask(gear_hash(row))`` per row."""
    return boundary_candidate_mask(gear_hash(batch, tables.gear), mask_bits)


def gear_mask(batch: torch.Tensor, tables, mask_bits: int) -> torch.Tensor:
    """[B, N] uint8 -> [B, N] bool: True where the top ``mask_bits`` of the
    gear hash at that position are zero (no length limit: every position).

    Rows are zero-padded on the right to a multiple of GEAR_TILE when N is
    not one; the hash is causal, so no output below N changes.
    """
    b, n = _check_rows(batch)
    if not 1 <= mask_bits <= 31:
        raise ValueError(f"mask_bits {mask_bits} outside [1, 31]")
    n_pad = -(-n // GEAR_TILE) * GEAR_TILE
    padded = batch
    if n_pad != n:
        padded = torch.zeros((b, n_pad), dtype=torch.uint8, device=batch.device)
        padded[:, :n] = batch
    if batch.device.type == "cpu":
        return gear_mask_plain(padded, tables, mask_bits)[:, :n].contiguous()
    if padded.data_ptr() % 16:
        raise ValueError("batch must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.uint8, device=batch.device)
    _launch(
        "gear_mask", batch.device, padded.data_ptr(), tables.gear_bits.data_ptr(), out.data_ptr(), n_pad, n, b,
        mask_bits, int(n % 16 == 0),
    )
    return out.view(torch.bool)


# ---- K-D: fixed-stride segment fingerprints ----


def _check_stride(n: int, seg: int) -> None:
    if seg < 1 or n % seg:
        raise ValueError(f"N={n} must be a multiple of fp_seg_bytes={seg}")
    if seg > MAX_FIXED_SEG:
        raise ValueError(f"fp_seg_bytes={seg} exceeds {MAX_FIXED_SEG}, past which the reference's limb sums wrap")


def segment_fp_fixed_plain(batch: torch.Tensor, seg: int, tables) -> torch.Tensor:
    """Plain version of K-D: the scatter-add form (``segment_fingerprint_device``)
    over fixed strides, power index ``min(seg-1-col, MAX_SEGMENT_BYTES-1)``."""
    b, n = batch.shape
    n_seg = n // seg
    dev = batch.device
    pos = torch.arange(n, device=dev)
    seg_ids = (torch.arange(b, device=dev)[:, None] * n_seg + pos // seg).reshape(-1)
    rev_pos = (seg - 1 - pos % seg).clamp(max=MAX_SEGMENT_BYTES - 1).expand(b, n).reshape(-1)
    lanes = segment_fingerprint_device(batch.reshape(-1), seg_ids, rev_pos, b * n_seg, tables.powers)
    return lanes.view(b, n_seg, N_LANES).to(torch.int32)


def segment_fp_fixed(batch: torch.Tensor, seg: int, tables) -> torch.Tensor:
    """[B, N] uint8 -> [B, N/seg, 8] int32 lanes in [0, M31) (uint32 values)
    of the stride-``seg`` segments, for every ``seg`` that divides N up to
    2^24. Power indices past MAX_SEGMENT_BYTES - 1 are clamped, as the
    reference's gather clamps them."""
    b, n = _check_rows(batch)
    _check_stride(n, seg)
    if batch.device.type == "cpu":
        return segment_fp_fixed_plain(batch, seg, tables)
    n_seg = n // seg
    words = seg % FP_WORD == 0 and batch.data_ptr() % 16 == 0  # else the byte path
    splits, cols = 1, seg
    if not words:
        splits = max(1, min(-(-FP_FIXED_BLOCKS // (b * n_seg)), -(-seg // FP_FIXED_STEP)))
        cols = -(-seg // splits)
        cols = -(-cols // FP_FIXED_STEP) * FP_FIXED_STEP  # whole block steps per split
        splits = -(-seg // cols)
        if n_seg * splits >= 1 << 31:
            raise ValueError(f"{n_seg} segments of {seg} bytes exceed the grid")
    acc = torch.empty((b, n_seg, N_LANES), dtype=torch.int64, device=batch.device)  # u64 scratch
    out = torch.empty((b, n_seg, N_LANES), dtype=torch.int32, device=batch.device)
    _launch(
        "segment_fp_fixed", batch.device, batch.data_ptr(), tables.powers_bits.data_ptr(),
        tables.word_limbs.data_ptr(), tables.word_powers.data_ptr(), acc.data_ptr(), out.data_ptr(), n, seg, b,
        splits, cols, MAX_SEGMENT_BYTES, int(words),
    )
    return out


# ---- K-E: blockpack encode ----


def blockpack_encode_plain(batch: torch.Tensor, block_bytes: int):
    """Plain version of K-E: the reference's ``encode_device`` per row (block
    tags, then a stable compaction by prefix sum and scatter)."""
    b, n = batch.shape
    nb = n // block_bytes
    blocks = batch.view(b, nb, block_bytes)
    first = blocks[:, :, :1]
    is_const = (blocks == first).all(-1)
    is_zero = is_const & (first[:, :, 0] == 0)
    tags = torch.where(is_zero, TAG_ZERO, torch.where(is_const, TAG_CONST, TAG_LITERAL)).to(torch.uint8)
    kept = torch.where(tags == TAG_LITERAL, block_bytes, torch.where(tags == TAG_CONST, 1, 0)).long()
    offsets = torch.cumsum(kept, -1) - kept
    col = torch.arange(block_bytes, device=batch.device)
    keep = (tags == TAG_LITERAL)[:, :, None] | ((tags == TAG_CONST)[:, :, None] & (col == 0))
    dest = torch.where(keep, offsets[:, :, None] + col, n).view(b, n)  # dropped bytes land in column n
    literals = torch.zeros((b, n + 1), dtype=torch.uint8, device=batch.device)
    literals.scatter_(1, dest, batch)
    return tags, literals[:, :n].contiguous(), kept.sum(-1).to(torch.int32)


def blockpack_tile_bytes(block_bytes: int) -> int:
    """K-E's tile: the most whole blocks that fit in ``BLOCKPACK_TILE`` bytes,
    or one block when a block is larger. A row's last tile may be shorter."""
    return block_bytes * max(1, BLOCKPACK_TILE // block_bytes)


def blockpack_encode(batch: torch.Tensor, block_bytes: int):
    """[B, N] uint8 -> (tags [B, N/block_bytes] uint8, literals [B, N] uint8,
    n_lit [B] int32): per block zero (0), constant (1) or literal (2); the
    kept bytes (a literal block whole, one byte of a constant block) as a
    dense prefix in block order, zero after ``n_lit``. Any ``block_bytes``
    that divides N; rows of any length and alignment."""
    b, n = _check_rows(batch)
    if block_bytes < 1 or n % block_bytes:
        raise ValueError(f"N={n} must be a multiple of block_bytes={block_bytes}")
    if batch.device.type == "cpu":
        return blockpack_encode_plain(batch, block_bytes)
    dev = batch.device
    tags = torch.empty((b, n // block_bytes), dtype=torch.uint8, device=dev)
    literals = torch.empty((b, n), dtype=torch.uint8, device=dev)
    n_lit = torch.empty((b,), dtype=torch.int32, device=dev)
    n_tiles = -(-n // blockpack_tile_bytes(block_bytes))
    scratch = torch.empty((1 + b * n_tiles,), dtype=torch.int64, device=dev)  # ticket, status words
    _launch(
        "blockpack_encode", dev, batch.data_ptr(), tags.data_ptr(), literals.data_ptr(), n_lit.data_ptr(),
        scratch.data_ptr(), scratch.numel(), n, block_bytes, b,
    )
    return tags, literals, n_lit
