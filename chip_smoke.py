"""Smoke run of the skyplane_tpu_torch data path and gateway on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final ``ok`` line):

1. Device, torch and CUDA versions, the card's name and power limit; build
   the CUDA kernels from ``skyplane_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print the build seconds, each kernel's registers, spills
   and shared memory (ptxas), and the integer mma (IMMA) count in the SASS
   of the two fingerprint kernels, which fails if it is 0. Beside them, g++
   builds the native host library (``skyplane_tpu_torch/native``): its path,
   build seconds and whether ``-march=native`` took; it fails if the library
   is not available. Whether the system liblz4 is present.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 8 rows of an 8 MiB bucket, cap 4096, 2050 slots) with
   a zero row, a short row with its garbage end and sentinel-padded ends;
   ``gear_compact`` also at an overflowing cap of 16, at mask bits 4 (the
   cap hit mid-chunk) and over 20 repeated launches, bit for bit, and its
   device time traced; ``segment_fp`` also on four adversarial rows (ends
   at every residue mod 64 with ends 1 byte apart and at 64k - 1, 64k,
   64k + 1; all 0xFF bytes; a segment of 2^19 bytes, clamped; the bucket as
   the only end). Equality is exact (integer outputs). Each kernel and plain
   version is timed with CUDA events and printed beside its bound.
3. The main path: ``DataPathProcessor(dedup=True)`` over a
   ``DeviceBatchRunner(max_batch=8)`` with 16 sender threads, on the bench's
   snapshot-chain corpus (4 snapshots x 6 chunks x 8 MiB, seed 0), with
   fingerprints committed after each chunk, in four passes: (a) codec
   ``tpu`` with the native host library off, (b) ``tpu`` with it on (the
   main path; its launches go in the kernel line), (c) ``native_lz``, (d)
   ``lz4`` when liblz4 is present; two rounds in turns (a b c d, d c b a).
   Launch counts are zeroed just before each pass and read just after. Each
   pass prints Gbps, wire reduction, REF segments, batch windows and the
   host split: per-thread CPU and wall time of the codec, the recipe, the
   boundary selection, the staging copies, the blake2b finalize and the
   leaders' batch runs, from wrappers this script installs, and the device
   wait. Then: every chunk of each pass restores byte-identical under
   paranoid verify (timed, with the library on and off), and sampled wire
   bytes of codecs ``tpu`` and ``native_lz`` are equal across the device
   path and the host path with the library on and off.
4. One more pass of the main path under torch.profiler: the device's busy
   share of the wall time, device time by kernel or copy, and the traced
   time and launches of each kernel of the path. An error of the data path
   fails this phase like any other.
5. The fused batch step ``datapath_step`` (slice 2) at B = 8 x 8 MiB on the
   corpus's first 8 chunks, block 512, fingerprint stride 64 KiB, mask bits
   16, with launch counts zeroed just before and read just after. Its
   outputs are checked (shapes, ranges, every row's literals decode
   byte-identical through the host decoder, the ``entry()`` twin on the card
   equals its CPU run), and each of its kernels (``gear_mask``,
   ``segment_fp_fixed``, ``blockpack_encode``) equals its plain version
   exactly on those rows and on adversarial ones (all-zero, constant, a
   repeated 1 KiB pattern, random), ``segment_fp_fixed`` also at strides
   4096, 2^17, 2^19 (past the power table: clamped) and 64, and at 1000 (its
   byte path) on the rows cut to 8192000 bytes, ``blockpack_encode`` also at
   blocks 1, 4, 16, 600, 4096 and 40960 (larger than its tile) on the rows
   cut to a multiple of the block, and on the batch at storage offset 1.
   Kernel, plain and whole-step times with CUDA events, beside each
   kernel's bound; ``blockpack_encode`` also by traced device time, beside
   a device-to-device copy of the same bytes, and at the other blocks; then
   20 steps under torch.profiler: the device's busy share of their wall
   time.
6. The gateway through two port gateway daemons (slices 7 and 8):
   ``GatewayDaemon(device="cuda")`` twice, in process on threads (control
   port 0 on 127.0.0.1, plaintext control and data), each building its own
   ``DeviceBatchRunner(max_batch=8)``. The source's program is
   ``read_local`` (8 workers) -> ``send`` (16 connections, window 16, codec
   ``tpu``, dedup); the destination's is ``receive`` (dedup) ->
   ``write_local``. The corpus is written as 24 source files and dispatched
   with one ``POST /api/v1/chunk_requests`` to the source; the round ends
   when the destination's ``/api/v1/chunk_status_log`` reports all 24
   complete, and every destination file is held against its source. Each
   round starts fresh daemons (fresh runners, index and segment store). Two
   rounds with ``SKYPLANE_TPU_PARANOID_VERIFY=1`` (recipe chunks
   re-fingerprinted on the card through the destination's runner), launch
   counts zeroed just before the first and read just after the second; a
   witness round at the daemon's default (paranoid verification off); a
   traced round under torch.profiler (the device's busy share). Each round
   prints Gbps of raw bytes from the POST to the last completion, wire
   bytes, wire reduction, REF share, NACKs and resends, ack lag, each
   daemon runner's K-AB and K-C launches and ``phase.first_compile``
   interval (from ``GET /api/v1/events``), the destination's
   ``verify_counters()`` and the host split by stage; then the paranoid
   rounds beside the witness round (Gbps, ack lag, REF share, the recipe
   restore's wall) and phase 3 (b)'s Gbps. It fails if a destination file
   differs from its source, a daemon reports an error, a runner that should
   work launches no K-AB or K-C (the destination's only in paranoid rounds),
   a runner that launched journals no ``phase.first_compile``, or
   ``verify_batched`` is not 24 of 24 in a paranoid round.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line describing every kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

CHUNK_MB = 8
N_SNAPSHOTS = 4
CHUNKS_PER_SNAPSHOT = 6
ZERO_FRAC = 0.25
BLOCK = 4096
WRITE_SITE_FRAC = 0.004
WRITE_RUN_BLOCKS = 8
WORKERS = 16
MAX_BATCH = 8
SEED = 0
# datapath_step's defaults (phase 5)
STEP_BLOCK = 512
STEP_FP_SEG = 1 << 16
STEP_MASK_BITS = 16
STEP_EXTRA_STRIDES = (4096, 1 << 17, 1 << 19, 64)
STEP_ODD_STRIDE = 1000  # not a multiple of 64: K-D's byte path, on the first 8192000 bytes of each row
# K-E's other block sizes, each on the step rows cut to a multiple of it: one
# byte, small blocks (a thread per run of blocks), a block that is not a power
# of two, and one larger than a tile (streamed twice)
STEP_EXTRA_BLOCKS = (1, 4, 16, 600, 4096, 40960)
SLICE1 = ("gear_compact", "segment_fp")
SLICE2 = ("gear_mask", "segment_fp_fixed", "blockpack_encode")

# the card's peak rates (NVIDIA H100 SXM): HBM bytes/s from the data sheet;
# the 32-bit integer instruction rate: the data sheet gives 67e12 float32
# FLOP/s (128 FP32 lanes per SM, a multiply-add counted as two), and a Hopper
# SM has 64 INT32 lanes, so it issues 67e12 / 2 / 2 integer instructions/s;
# and the dense int8 tensor-core rate, 1979e12 operations/s (a multiply-add
# counted as two). The kernels' CUDA-core work is counted as 32-bit integer
# instructions at the integer rate; the fingerprint kernels' u8 products
# (segment_fp, segment_fp_fixed) as tensor-core operations at the int8 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_INSTR_PER_S = 67e12 / 4
PEAK_INT8_TENSOR_OPS_PER_S = 1979e12
# the fingerprint kernels' work per 64-byte word: its u8 product with the
# [64, 32] word_limbs matrix (64 x 32 multiply-adds), and 18 integer
# instructions per word and lane counted from csrc/lane_poly.cuh: word_values
# joins and exchanges the limbs and folds (10: two shift-adds, three selects,
# a shuffle, four for the 2^16 weight and the fold), mul_lazy31 (4), the
# running u64 sum (2), the power read and the zero test (2)
WORD_TENSOR_OPS = 2 * 64 * 32
WORD_INT_INSTR = 18 * 8


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- corpus: a copy of bench.py's snapshot-chain generator ----


def _clustered_mask(rng, n_blocks: int, site_frac: float, mean_run: int) -> np.ndarray:
    mask = np.zeros(n_blocks, bool)
    n_sites = max(1, int(n_blocks * site_frac))
    starts = rng.integers(0, n_blocks, n_sites)
    lengths = rng.geometric(1.0 / mean_run, n_sites)
    for s, l in zip(starts, lengths):
        mask[s : s + l] = True
    return mask


def _filesystem_content(rng, n_bytes: int) -> np.ndarray:
    """~35% text-like runs, ~25% structured records, the rest incompressible
    (the caller adds ~25% clustered zero extents)."""
    out = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    n_blocks = n_bytes // BLOCK
    text = _clustered_mask(rng, n_blocks, 0.35 / 24, 24)
    tmask = np.repeat(text, BLOCK)
    n_text = int(tmask.sum())
    if n_text:
        vocab = ((rng.integers(0, 256, (512, 8), dtype=np.uint8) & 0x3F) | 0x20).reshape(512, 8)
        toks = rng.integers(0, 512, n_text // 8 + 1)
        out[tmask] = vocab[toks].reshape(-1)[:n_text]
    rec = _clustered_mask(rng, n_blocks, 0.25 / 24, 24) & ~text
    run_id = np.cumsum(rec & ~np.concatenate([[False], rec[:-1]]))
    out2d = out.reshape(n_blocks, BLOCK)
    for rid in np.unique(run_id[rec]):
        blocks = np.flatnonzero(rec & (run_id == rid))
        record = rng.integers(0, 256, 64, dtype=np.uint8)
        span = np.tile(record, (len(blocks) * BLOCK) // 64)
        edits = rng.integers(0, len(span), max(1, len(span) // 32))
        span[edits] = rng.integers(0, 256, len(edits), dtype=np.uint8)
        out2d[blocks] = span.reshape(len(blocks), BLOCK)
    return out


def make_corpus(seed: int = SEED):
    """Snapshot chain: each snapshot is the previous one with clustered writes."""
    rng = np.random.default_rng(seed)
    chunk_bytes = CHUNK_MB << 20
    n_blocks = chunk_bytes // BLOCK
    snap = []
    for _ in range(CHUNKS_PER_SNAPSHOT):
        blocks = _filesystem_content(rng, chunk_bytes).reshape(n_blocks, BLOCK)
        blocks[_clustered_mask(rng, n_blocks, ZERO_FRAC / 16, 16)] = 0
        snap.append(blocks)
    chunks = [b.reshape(-1).tobytes() for b in snap]
    for _ in range(N_SNAPSHOTS - 1):
        nxt = []
        for b in snap:
            b2 = b.copy()
            mut = _clustered_mask(rng, n_blocks, WRITE_SITE_FRAC, WRITE_RUN_BLOCKS)
            b2[mut] = _filesystem_content(rng, int(mut.sum()) * BLOCK).reshape(-1, BLOCK)
            nxt.append(b2)
        chunks.extend(b.reshape(-1).tobytes() for b in nxt)
        snap = nxt
    return chunks


# ---- phase helpers ----


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events around the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced_ms(fn, name: str, reps: int) -> str:
    """``reps`` calls of ``fn`` under torch.profiler: the device time per call
    of the kernels whose name holds ``name`` and of the memsets beside them,
    without the host's enqueue pace. Only the profiler's own failures read
    "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler did not start: {err!r})"
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        return f"not measured (profiler events unreadable: {err!r})"
    kern = [e.time_range.elapsed_us() for e in events if name in e.name]
    memset = [e.time_range.elapsed_us() for e in events if "memset" in e.name.lower()]
    if not kern:
        return "not measured (no device events traced)"
    return (f"{sum(kern) / 1e3 / reps:.4f} ms of kernel time per call ({len(kern)} kernels over {reps} calls), "
            f"memset {sum(memset) / 1e3 / reps:.4f} ms per call")


def bound_ms(n_bytes: float, n_instr: float, n_tensor_ops: float = 0.0):
    """The least time for the work: the largest of the bytes at the HBM rate,
    the integer instructions at the INT32 rate and the u8 tensor-core
    operations at the int8 rate, and which of bytes or operations it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_instr / PEAK_INT_INSTR_PER_S, n_tensor_ops / PEAK_INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def word_work(batch: torch.Tensor, n_split: int = 0):
    """(integer instructions, tensor-core operations) that the fingerprint
    kernels' word design needs for this batch: every word with a nonzero
    byte, and a second product for each of ``n_split`` words that an end
    cuts."""
    words = int((batch.view(-1, 64) != 0).any(1).sum().item()) + n_split
    return words * WORD_INT_INSTR, words * WORD_TENSOR_OPS


def power_rows_read(ends: np.ndarray, bucket: int, max_seg: int) -> int:
    """The 32-byte rows of word_powers that K-C reads for these ends: a
    segment ending at c reads rows (c % 64, m) for m below its length / 64."""
    c = np.minimum(np.maximum(ends.astype(np.int64), 0), bucket)
    start = np.concatenate([np.zeros((len(c), 1), np.int64), c[:, :-1]], 1)
    length = np.minimum(c - np.minimum(start, c), max_seg)
    need = np.zeros(64, np.int64)
    np.maximum.at(need, (c % 64).reshape(-1), -(-length // 64).reshape(-1))
    return int(need.sum())


def split_words(ends: np.ndarray, bucket: int) -> int:
    """Words that exactly one end cuts strictly inside (K-C's second product)."""
    n = 0
    for row in np.minimum(np.maximum(ends.astype(np.int64), 0), bucket):
        inside = row[(row % 64 != 0) & (row < bucket)]
        _, counts = np.unique(inside // 64, return_counts=True)
        n += int((counts == 1).sum())
    return n


def adversarial_ends_rows(bucket: int, n_slots: int, rng):
    """K-C's adversarial rows at the main path's shapes: ends at every residue
    mod 64 (with two ends 1 byte apart and ends at 64k - 1, 64k, 64k + 1), a
    row of 0xFF bytes, a random row with one segment of 2^19 bytes (past the
    power table: clamped), and a random row whose only end is the bucket."""
    rows = rng.integers(0, 256, (4, bucket), dtype=np.uint8)
    rows[1] = 0xFF
    ends = np.full((4, n_slots), bucket, np.int32)
    e = sorted({(1 << 16) * (k + 1) + 64 * k + k for k in range(64)}
               | {5000, 5001, 8191, 8192, 8193, 3 << 20, (3 << 20) + 1, (3 << 20) + 2})
    ends[0, : len(e)] = e
    e1 = np.cumsum(rng.integers(64, 1 << 15, 800))
    e1 = np.unique(e1[e1 < bucket])
    ends[1, : len(e1)] = e1
    ends[2, :3] = [4097, 4097 + (1 << 19), 4097 + (1 << 19) + 63]
    return rows, ends


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max().item())


def ends_slots_for(packed: np.ndarray, lens, bucket: int, params, cap: int, n_slots: int) -> np.ndarray:
    from skyplane_tpu_torch.ops.cdc import select_boundaries

    ends = np.full((len(lens), n_slots), bucket, np.int32)
    for i, n in enumerate(lens):
        e = select_boundaries(packed[i, : packed[i, cap]].astype(np.int64), int(n), params)
        ends[i, : len(e)] = e
        if n < bucket:
            ends[i, len(e)] = bucket
    return ends


def check_kernels(dev, chunks, params):
    """Phase 2: every kernel == its plain version at the main path's shapes."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.fingerprint import N_LANES
    from skyplane_tpu_torch.ops.fused_cdc import candidate_cap, slots_cap
    from skyplane_tpu_torch.state import device_tables

    tables = device_tables(dev)
    bucket = CHUNK_MB << 20
    cap, n_slots = candidate_cap(bucket, params), slots_cap(bucket, params)
    rng = np.random.default_rng(1)
    rows = np.stack([np.frombuffer(c, np.uint8) for c in chunks[:MAX_BATCH]])  # corpus rows
    rows[5] = 0  # all-zero row (a batch pad row, n = 0)
    short = bucket * 3 // 8 + 17
    rows[6, short:] = 0  # short row: a garbage end covers its zero padding
    rows[7] = rng.integers(0, 256, bucket, dtype=np.uint8)
    lens = [bucket] * MAX_BATCH
    lens[5], lens[6] = 0, short
    batch = torch.from_numpy(rows).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    errs = {}

    packed = kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap)
    errs["gear_compact"] = max_abs_err(packed, kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, cap))
    over = kernels.gear_compact(batch, lens_t, tables, params.mask_bits, 16)  # every full row overflows a cap of 16
    errs["gear_compact"] = max(errs["gear_compact"], max_abs_err(over, kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, 16)))
    dense = kernels.gear_compact(batch, lens_t, tables, 4, cap)  # mask_bits 4: the cap is hit mid-chunk
    errs["gear_compact"] = max(errs["gear_compact"], max_abs_err(dense, kernels.gear_compact_plain(batch, lens_t, tables, 4, cap)))
    repeats = sum(max_abs_err(kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), packed) for _ in range(20))
    errs["gear_compact"] = max(errs["gear_compact"], repeats)  # chunks run in another order each launch
    packed_np = packed.cpu().numpy()
    n_over = int((over.cpu().numpy()[:, 16] > 16).sum())
    if n_over < 5:
        raise AssertionError(f"a cap of 16 should overflow the full rows: {over.cpu().numpy()[:, 16].tolist()}")
    n_dense = dense.cpu().numpy()[:, cap]
    if (n_dense > cap).sum() < 5:
        raise AssertionError(f"mask_bits 4 should overflow the cap on the full rows: {n_dense.tolist()}")
    del over, dense

    ends = torch.from_numpy(ends_slots_for(packed_np, lens, bucket, params, cap, n_slots)).to(dev)
    n_real = int((ends.cpu().numpy() < bucket).sum())
    lanes = kernels.segment_fp(batch, ends, tables)
    errs["segment_fp"] = max_abs_err(lanes, kernels.segment_fp_plain(batch, ends, tables))
    adv_rows, adv_ends = adversarial_ends_rows(bucket, n_slots, rng)
    adv_b, adv_e = torch.from_numpy(adv_rows).to(dev), torch.from_numpy(adv_ends).to(dev)
    adv_err = max_abs_err(kernels.segment_fp(adv_b, adv_e, tables), kernels.segment_fp_plain(adv_b, adv_e, tables))
    errs["segment_fp"] = max(errs["segment_fp"], adv_err)
    del adv_b, adv_e
    torch.cuda.empty_cache()
    sync(dev)
    log(f"phase 2: B={MAX_BATCH} bucket={bucket} cap={cap} n_slots={n_slots}: "
        f"candidates per row {packed_np[:, cap].tolist()}, rows over a cap of 16: {n_over}, at mask_bits 4 {n_dense.tolist()}, "
        f"real segment ends {n_real} of {MAX_BATCH * n_slots} slots, max |kernel - plain| {errs} (gear_compact also at a cap "
        f"of 16, at mask_bits 4 and over 20 repeated launches); segment_fp on the adversarial rows (end residues mod 64, "
        f"0xFF, a 2^19 segment, the bucket as the only end): {adv_err}")
    if any(errs.values()):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")

    # timing at the same shapes; the plain versions are the same arithmetic, no yardstick of speed
    t = {
        "gear_compact": (
            time_ms(lambda: kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), 200),
            time_ms(lambda: kernels.gear_compact_plain(batch, lens_t, tables, params.mask_bits, cap), 3, 1),
        ),
        "segment_fp": (
            time_ms(lambda: kernels.segment_fp(batch, ends, tables), 50),
            time_ms(lambda: kernels.segment_fp_plain(batch, ends, tables), 3, 1),
        ),
    }
    traced = traced_ms(lambda: kernels.gear_compact(batch, lens_t, tables, params.mask_bits, cap), "gear_compact", 200)
    # bounds from this run's inputs: each input read once, each output written once
    n_in = MAX_BATCH * bucket
    ends_np = ends.cpu().numpy()
    bounds = {
        # read bytes + lens + table; write [B, cap+1] i32 and 16 bytes of
        # status per chunk. Per byte: the hash step (one shift-add), the
        # top-bits test, the length test and the bit set
        "gear_compact": bound_ms(
            n_in + 4 * MAX_BATCH + 1024 + 4 * packed.numel() + 16 * MAX_BATCH * -(-bucket // kernels.GEAR_CHUNK),
            4 * n_in,
        ),
        # read bytes, ends, word_limbs and the word_powers rows the segments
        # index; write the lanes. Per word with a nonzero byte (twice for a
        # word an end cuts): its u8 product and 18 integer instructions a lane
        "segment_fp": bound_ms(
            n_in + 4 * ends.numel() + 64 * 32 + 32 * power_rows_read(ends_np, bucket, kernels.MAX_SEGMENT_BYTES)
            + 4 * lanes.numel(),
            *word_work(batch, split_words(ends_np, bucket)),
        ),
    }
    for name, (ms, plain_ms) in t.items():
        b, by = bounds[name]
        log(f"  {name}: {ms:.4f} ms/launch (plain {plain_ms:.3f} ms), bound {b:.4f} ms ({by}), {b / ms:.1%} of bound")
    read_ms = time_ms(lambda: batch.view(torch.int32).max(), 100)  # a yardstick for K-AB's reads, not its function
    log(f"  gear_compact traced: {traced}; a PyTorch reduction reading the same {n_in} bytes (int32 max): {read_ms:.4f} ms")
    return errs, t, bounds


def host_wire(chunk: bytes, index, codec, params):
    """What ``DataPathProcessor.process`` sends, computed on the host path
    (CDC + fingerprints by ``cdc_and_fps_host``, no device: the native
    library or numpy, as ``native.datapath`` is set)."""
    from skyplane_tpu_torch.ops.cdc import cdc_and_fps_host
    from skyplane_tpu_torch.ops.dedup import build_recipe

    ends, fps = cdc_and_fps_host(np.frombuffer(chunk, np.uint8), params)
    starts = np.concatenate([[0], ends[:-1]])
    segments = [(fp, chunk[s:e]) for fp, s, e in zip(fps, starts.tolist(), ends.tolist())]
    wire, n_ref, _, new_fps, _ = build_recipe(segments, index, codec.encode)
    return wire, n_ref, new_fps


class HostSplit:
    """Host time of the sender path by part, from wrappers installed around
    the package's functions for one pass (nothing is counted inside the
    package): per-thread CPU time (``time.thread_time_ns``) and wall time
    (``perf_counter_ns``), summed over the sender threads. A call nested in
    another of its own part counts once."""

    PARTS = ("codec", "recipe_with_codec", "select_boundaries", "staging", "blake2b", "leader_batch")

    def __init__(self):
        self.cpu_ns = dict.fromkeys(self.PARTS, 0)
        self.wall_ns = dict.fromkeys(self.PARTS, 0)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._undo = []

    def wrap(self, part: str, fn):
        def timed(*args, **kwargs):
            active = self._tls.__dict__.setdefault("active", set())
            if part in active:
                return fn(*args, **kwargs)
            active.add(part)
            c0, w0 = time.thread_time_ns(), time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                dc, dw = time.thread_time_ns() - c0, time.perf_counter_ns() - w0
                active.discard(part)
                with self._lock:
                    self.cpu_ns[part] += dc
                    self.wall_ns[part] += dw

        return timed

    def _patch(self, owner, name: str, part: str, static: bool = False) -> None:
        import inspect

        orig = inspect.getattr_static(owner, name)
        fn = orig.__func__ if static else orig
        setattr(owner, name, staticmethod(self.wrap(part, fn)) if static else self.wrap(part, fn))
        self._undo.append((owner, name, orig))

    def install(self, proc) -> None:
        from skyplane_tpu_torch.ops import batch_runner, fused_cdc, pipeline

        proc.codec = proc.codec._replace(encode=self.wrap("codec", proc.codec.encode))
        self._patch(pipeline, "build_recipe", "recipe_with_codec")
        self._patch(fused_cdc, "select_boundaries", "select_boundaries")
        self._patch(fused_cdc.FusedCDCFP, "stage", "staging")
        self._patch(fused_cdc.FusedCDCFP, "_upload", "staging")
        self._patch(fused_cdc, "digests_from_lanes", "blake2b")
        self._patch(pipeline.DataPathProcessor, "_chunk_fingerprint", "blake2b", static=True)
        self._patch(batch_runner.DeviceBatchRunner, "_run_batch", "leader_batch")

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def summary(self, device_wait_ns: int) -> str:
        cpu = dict(self.cpu_ns)
        wall = dict(self.wall_ns)
        cpu["recipe"] = cpu.pop("recipe_with_codec") - cpu["codec"]
        wall["recipe"] = wall.pop("recipe_with_codec") - wall["codec"]
        parts = ("codec", "recipe", "select_boundaries", "staging", "blake2b", "leader_batch")
        return ("host split, CPU ms / wall ms summed over threads: " + ", ".join(
            f"{k} {cpu[k] / 1e6:.1f} / {wall[k] / 1e6:.1f}" for k in parts) + f", device wait (wall) {device_wait_ns / 1e6:.1f} "
            "(leader_batch: the leaders' batch runs, call A to call B's readback, selection and staging of the batch inside)")


def thread_clock_step_ns(samples: int = 5) -> int:
    """The smallest step of the per-thread CPU clock seen while spinning: the
    resolution of the CPU ms of the host split on this machine."""
    steps = []
    for _ in range(samples):
        t0 = time.thread_time_ns()
        deadline = time.perf_counter() + 0.2
        t1 = t0
        while t1 == t0 and time.perf_counter() < deadline:
            t1 = time.thread_time_ns()
        steps.append(t1 - t0)
    return min(steps)


def sender_pass(dev, runner, chunks, params, codec: str, native_on: bool, label: str, card: str) -> dict:
    """One timed pass of the sender path over the corpus (16 threads, fresh
    index, fingerprints committed per chunk) with the host split, launch
    counts zeroed just before and read just after."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    native_dp._available = native_on
    proc = DataPathProcessor(codec_name=codec, dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    index = SenderDedupIndex()
    done_order, payloads = [], {}
    order_lock = threading.Lock()

    def one(i: int) -> None:
        p = proc.process(chunks[i], index)
        with order_lock:  # delivered -> commit (sender contract), in delivery order
            for fp, size in p.new_fingerprints:
                index.add(fp, size)
            payloads[i] = p
            done_order.append(i)

    raw_total = sum(len(c) for c in chunks)
    split = HostSplit()
    split.install(proc)
    overflow0 = runner.fused.overflow_rows
    pre = runner.counters()
    try:
        sync(dev)
        kernels.reset_launch_counts()
        cpu0, t0 = time.process_time(), time.perf_counter()
        with ThreadPoolExecutor(max_workers=WORKERS) as pool:
            list(pool.map(one, range(len(chunks))))
        sync(dev)
        dt, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
        launches = kernels.launch_counts()
    finally:
        split.uninstall()
    post = runner.counters()
    wire_total = sum(len(p.wire_bytes) for p in payloads.values())
    n_seg = sum(p.n_segments for p in payloads.values())
    n_ref = sum(p.n_ref_segments for p in payloads.values())
    gbps = raw_total * 8 / dt / 1e9
    log(f"phase 3 ({label}) on {card}: codec {codec}, native library {'on' if native_on else 'off'}: {len(chunks)} chunks / "
        f"{raw_total} bytes in {dt:.3f} s = {gbps:.3f} Gbps effective; process CPU {cpu_s:.3f} s ({cpu_s / dt:.2f} cores); "
        f"wire reduction {raw_total / wire_total:.3f}x ({wire_total} wire bytes); REF segments {n_ref} of {n_seg}; "
        f"overflow rows {runner.fused.overflow_rows - overflow0}; batch windows {post['batch_windows'] - pre['batch_windows']}, "
        f"padded rows {post['batch_padded_rows'] - pre['batch_padded_rows']}; kernel launches {launches}")
    log(f"phase 3 ({label}): " + split.summary(proc.stats.as_dict()["device_wait_ns"]))
    if any(launches[k] == 0 for k in SLICE1):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if n_ref == 0:
        raise AssertionError("no REF segments on a snapshot chain")
    return dict(launches=launches, payloads=payloads, done_order=done_order, gbps=gbps)


def check_sample(dev, runner, chunks, params, codec_name: str) -> None:
    """Sampled wire bytes: the device path's equal the host path's with the
    native library on and with it off (fresh indexes, one chunk at a time)."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.codecs import get_codec
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    codec = get_codec(codec_name)
    sample = [0, 1, 2, 3, 4, 5, 6, 12]  # 6 and 12 are later snapshots of chunk 0
    native_dp._available = True
    seq = DataPathProcessor(codec_name=codec_name, dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    indexes = [SenderDedupIndex() for _ in range(3)]
    sample_refs = 0
    t_on = t_off = 0.0
    for i in sample:
        native_dp._available = True
        p = seq.process(chunks[i], indexes[0])
        t0 = time.perf_counter()
        on = host_wire(chunks[i], indexes[1], codec, params)
        t1 = time.perf_counter()
        native_dp._available = False
        off = host_wire(chunks[i], indexes[2], codec, params)
        t_on, t_off = t_on + t1 - t0, t_off + time.perf_counter() - t1
        native_dp._available = True
        if not (p.wire_bytes == on[0] == off[0]) or not (p.n_ref_segments == on[1] == off[1]):
            raise AssertionError(f"chunk {i}, codec {codec_name}: wire bytes differ between the device path and the host path")
        sample_refs += on[1]
        for index, new in zip(indexes, (p.new_fingerprints, on[2], off[2])):
            for fp, size in new:
                index.add(fp, size)
    if sample_refs == 0:
        raise AssertionError("the sampled near-duplicates carried no REF segment")
    log(f"phase 3: codec {codec_name}: wire bytes of chunks {sample} equal across the device path and the host path "
        f"with the native library on and off ({sample_refs} REF segments); host path {t_on:.3f} s on, {t_off:.3f} s off")


def check_restore(dev, chunks, params, result: dict, native_on: bool, label: str) -> None:
    """Every chunk of a pass restores byte-identical under paranoid verify,
    in delivery order; the receiver's literal check runs natively when the
    library is on."""
    from skyplane_tpu_torch.chunk import ChunkFlags, WireProtocolHeader
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.dedup import SegmentStore
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    native_dp._available = native_on
    receiver = DataPathProcessor(codec_name="none", dedup=True, cdc_params=params, paranoid_verify=True, device=dev)
    store = SegmentStore()
    t0 = time.perf_counter()
    for i in result["done_order"]:
        p = result["payloads"][i]
        header = WireProtocolHeader(
            chunk_id=uuid.uuid4().hex, data_len=len(p.wire_bytes), raw_data_len=p.raw_len, codec=int(p.codec),
            flags=int(ChunkFlags.RECIPE) if p.is_recipe else 0, fingerprint=p.fingerprint,
        )
        got = receiver.restore(p.wire_bytes, header, store, ref_wait_timeout=5.0)
        if hashlib.blake2b(got, digest_size=16).digest() != hashlib.blake2b(chunks[i], digest_size=16).digest():
            raise AssertionError(f"pass {label}: chunk {i} did not restore byte-identical")
    dt = time.perf_counter() - t0
    native_dp._available = True
    log(f"phase 3 ({label}): all {len(result['done_order'])} chunks restored byte-identical (paranoid re-fingerprint on "
        f"the card), native library {'on' if native_on else 'off'}: {dt:.3f} s; verify_counters {receiver.verify_counters()}")


def main_path(dev, chunks, params, card: str, with_lz4: bool) -> dict:
    """Phase 3: the sender path over the corpus in passes (a) codec tpu with
    the native library off, (b) tpu with it on (the main path), (c)
    native_lz, (d) lz4 when liblz4 is present; two rounds in turns (a b c d,
    then d c b a). Then the checks. Returns the kernel launches of pass (b)'s
    first run and pass (b)'s Gbps in both rounds."""
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    runner = DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev)
    warm = DataPathProcessor(codec_name="tpu", dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    warm_rng = np.random.default_rng(99)
    warm_chunks = [warm_rng.integers(0, 256, CHUNK_MB << 20, dtype=np.uint8).tobytes() for _ in range(MAX_BATCH)]
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        list(pool.map(lambda c: warm.process(c, SenderDedupIndex()), warm_chunks))

    log(f"phase 3: the per-thread CPU clock steps by {thread_clock_step_ns() / 1e6:.3f} ms on this machine "
        "(the host split's CPU ms are sums of whole steps)")
    passes = {"a": ("tpu", False), "b": ("tpu", True), "c": ("native_lz", True)}
    if with_lz4:
        passes["d"] = ("lz4", True)
    else:
        log("phase 3: pass (d), codec lz4: not measured (liblz4.so.1 is not present on this machine)")
    first, gbps = {}, {k: [] for k in passes}
    for label in list(passes) + list(reversed(passes)):
        codec, native_on = passes[label]
        r = sender_pass(dev, runner, chunks, params, codec, native_on, label, card)
        gbps[label].append(r["gbps"])
        if label not in first:
            first[label] = r
            check_restore(dev, chunks, params, r, native_on, label)
    log(f"phase 3 on {card}: Gbps by pass over two rounds: " + "; ".join(
        f"({k}) {passes[k][0]}, native {'on' if passes[k][1] else 'off'}: " + ", ".join(f"{g:.3f}" for g in v)
        for k, v in gbps.items()))
    for codec in ("tpu", "native_lz"):
        check_sample(dev, runner, chunks, params, codec)
    return first["b"]["launches"], gbps["b"]


class GatewaySplit(HostSplit):
    """Host time of phase 6 by stage, summed over every thread of both
    gateways (same wrappers as HostSplit): the source's file reads, the
    sender's framing (the staged chunk read and the data path) and its data
    path alone, the receiver's socket reads, whole decode tasks and, inside
    them, the recipe assembly (literal blob decode, literal fingerprints,
    segment store), the paranoid re-fingerprint and the landing write; the
    destination's wait-receiver polls (20 ms sleeps included) and file
    writes."""

    PARTS = ("read_local", "frame", "sender_datapath", "recv", "decode", "recipe_restore", "paranoid_verify", "land",
             "wait_receiver", "write_local")

    def install(self, proc=None) -> None:
        from skyplane_tpu_torch.gateway.operators import gateway_operator as op
        from skyplane_tpu_torch.gateway.operators import gateway_receiver as rx
        from skyplane_tpu_torch.ops import pipeline

        self._patch(op.GatewayReadLocalOperator, "process", "read_local")
        self._patch(op.GatewaySenderOperator, "_frame_chunk", "frame")
        self._patch(pipeline.DataPathProcessor, "process", "sender_datapath")
        self._patch(rx.GatewayReceiver, "_recv_exact", "recv")
        self._patch(rx.GatewayReceiver, "_process_task", "decode")
        self._patch(pipeline, "parse_recipe", "recipe_restore")
        self._patch(pipeline.DataPathProcessor, "_cdc_and_fps", "paranoid_verify")
        self._patch(rx.GatewayReceiver, "_land", "land", static=True)
        self._patch(op.GatewayWaitReceiverOperator, "process", "wait_receiver")
        self._patch(op.GatewayWriteLocalOperator, "process", "write_local")

    def summary(self, device_wait_ns: int = 0) -> str:
        return "host split by stage, CPU ms / wall ms summed over threads: " + ", ".join(
            f"{k} {self.cpu_ns[k] / 1e6:.1f} / {self.wall_ns[k] / 1e6:.1f}" for k in self.PARTS)


GATEWAY_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_gateway"  # gitignored, inside the checkout
FIRST_COMPILE = "phase.first_compile"


class DaemonPair:
    """Phase 6's two port gateway daemons, in process on threads as
    ``tests/integration/harness.py`` starts them (control port 0 on
    127.0.0.1, plaintext control and data, each building its own
    ``DeviceBatchRunner`` on ``dev``): the source runs ``read_local`` (8) ->
    ``send`` (16 connections, codec ``tpu``, dedup, window 16) and the
    destination ``receive`` (dedup) -> ``write_local``. Driven through the
    control API with the port's standard-library client."""

    def __init__(self, dev, params, root: Path):
        from skyplane_tpu_torch.gateway.control_auth import control_session

        self.session = control_session()
        recv = {"op_type": "receive", "handle": "recv", "dedup": True,
                "children": [{"op_type": "write_local", "handle": "write", "children": []}]}
        self.dst = self._start(dev, params, root, "gw_dst", recv, {})
        send = {"op_type": "send", "handle": "send", "target_gateway_id": "gw_dst", "region": "local:local",
                "num_connections": WORKERS, "compress": "tpu", "dedup": True, "encrypt": False, "window": 16,
                "children": []}
        read = {"op_type": "read_local", "handle": "read", "num_connections": 8, "children": [send]}
        info = {"gw_dst": {"public_ip": "127.0.0.1", "control_port": self.dst[0].api.port}}
        self.src = self._start(dev, params, root, "gw_src", read, info)

    def _start(self, dev, params, root: Path, gateway_id: str, op: dict, info: dict):
        from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon
        from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

        # a CPU daemon builds no runner: a rehearsal on the CPU hands it one
        runner = (DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev, gateway_id=gateway_id)
                  if dev.type == "cpu" else None)
        daemon = GatewayDaemon(
            "local:local", str(root / gateway_id), {"plan": [{"partitions": ["default"], "value": [op]}]}, info,
            gateway_id, control_port=0, bind_host="127.0.0.1", use_tls=False, cdc_params=params, device=dev,
            batch_runner=runner,
        )
        if daemon.batch_runner is None:
            raise AssertionError(f"phase 6: daemon {gateway_id} on {dev} built no batch runner")
        thread = threading.Thread(target=daemon.run, name=f"daemon-{gateway_id}", daemon=True)
        thread.start()
        deadline = time.monotonic() + 30
        while True:
            try:
                self.get(daemon, "status")
                return daemon, thread
            except Exception:  # noqa: BLE001 — the control API is not up yet
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)

    def url(self, daemon, route: str) -> str:
        return f"http://127.0.0.1:{daemon.api.port}/api/v1/{route}"

    def get(self, daemon, route: str, **kw):
        resp = self.session.get(self.url(daemon, route), timeout=30, **kw)
        resp.raise_for_status()
        return resp.json()

    def dispatch(self, reqs) -> None:
        self.session.post(self.url(self.src[0], "chunk_requests"), json=[r.as_dict() for r in reqs], timeout=60).raise_for_status()

    def wait_complete(self, ids, timeout: float) -> None:
        """Poll the destination's ``/chunk_status_log`` every 10 ms until every
        id is complete; raise on an error at either daemon or the timeout."""
        pending, deadline, n = set(ids), time.monotonic() + timeout, 0
        while pending:
            status = self.get(self.dst[0], "chunk_status_log", params={"chunk_ids": ",".join(sorted(pending))})["chunk_status"]
            pending = {c for c in pending if status.get(c) != "complete"}
            n += 1
            if pending and n % 20 == 0:
                for daemon, _ in (self.src, self.dst):
                    errs = self.get(daemon, "errors")["errors"]
                    if errs:
                        raise AssertionError(f"phase 6: daemon {daemon.gateway_id} failed: {errs[0][:2000]}")
            if pending and time.monotonic() > deadline:
                raise AssertionError(f"phase 6: {len(pending)} of {len(ids)} chunks incomplete after {timeout:.0f} s")
            if pending:
                time.sleep(0.01)

    def first_compile(self, daemon, since: int):
        """The daemon runner's ``phase.first_compile`` interval in seconds from
        ``GET /api/v1/events`` (None when it journaled none)."""
        events = self.get(daemon, "events", params={"since": since})["events"]
        edges = {e["edge"]: e for e in events if e["kind"] == FIRST_COMPILE and e.get("gateway") == daemon.gateway_id}
        if set(edges) != {"start", "end"}:
            return None
        return edges["end"]["mono"] - edges["start"]["mono"], edges["start"]["bucket"], edges["start"]["rows"]

    def stop(self) -> None:
        for daemon, _ in (self.src, self.dst):
            daemon.stop()
        for daemon, thread in (self.src, self.dst):
            thread.join(timeout=30)
            if thread.is_alive():
                raise AssertionError(f"phase 6: daemon {daemon.gateway_id} did not stop")


def gateway_round(dev, files, chunks, params, card: str, label: str, paranoid: bool, trace: bool = False) -> dict:
    """One round of phase 6 through two fresh port daemons (fresh runners and
    index): POST the 24 chunk requests to the source, wait until the
    destination reports all 24 complete, check each file against its source.
    ``paranoid`` sets ``SKYPLANE_TPU_PARANOID_VERIFY=1`` for the daemons (off
    is the daemon's default: the witness round). Returns the round's numbers."""
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest
    from skyplane_tpu_torch.obs import get_recorder

    for _, dest in files:
        dest.unlink(missing_ok=True)
    saved = os.environ.pop("SKYPLANE_TPU_PARANOID_VERIFY", None)
    if paranoid:
        os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = "1"
    try:
        since = get_recorder().seq()
        pair = DaemonPair(dev, params, GATEWAY_DIR / f"round_{label}")
    finally:
        os.environ.pop("SKYPLANE_TPU_PARANOID_VERIFY", None)
        if saved is not None:
            os.environ["SKYPLANE_TPU_PARANOID_VERIFY"] = saved
    src, dst = pair.src[0], pair.dst[0]
    reqs = [
        ChunkRequest(chunk=Chunk(src_key=str(s), dest_key=str(d), chunk_id=uuid.uuid4().hex,
                                 chunk_length_bytes=len(c), file_offset_bytes=0),
                     src_region="local:local", dst_region="local:local", src_type="local", dst_type="local")
        for (s, d), c in zip(files, chunks)
    ]
    split = None if trace else GatewaySplit()
    if split is not None:
        split.install()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    try:
        cpu0, t0 = time.process_time(), time.perf_counter()
        pair.dispatch(reqs)
        pair.wait_complete([r.chunk.chunk_id for r in reqs], timeout=300.0)
        dt, cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
        for i, ((_, dest), c) in enumerate(zip(files, chunks)):
            if hashlib.blake2b(dest.read_bytes(), digest_size=16).digest() != hashlib.blake2b(c, digest_size=16).digest():
                raise AssertionError(f"phase 6 ({label}): destination file {i} differs from its source")
        sender = next(op for op in src.operators if type(op).__name__ == "GatewaySenderOperator")
        stats = sender.datapath_counters()
        wire = sender.wire_counters()
        decode = dst.receiver.decode_counters()
        verify = dst.receiver.processor.verify_counters()
        compiles = {d.gateway_id: pair.first_compile(d, since) for d in (src, dst)}
    finally:
        if prof is not None:
            sync(dev)
            prof.stop()
        if split is not None:
            split.uninstall()
        pair.stop()
    raw_total = sum(len(c) for c in chunks)
    gbps = raw_total * 8 / dt / 1e9
    launches = {d.gateway_id: d.batch_runner.fused.launch_counts() for d in (src, dst)}
    ref_share = stats["ref_segments"] / stats["segments"] if stats["segments"] else 0.0
    log(f"phase 6 ({label}, paranoid verify {'on' if paranoid else 'off: the daemon default'}) on {card}: two port "
        f"daemons, {len(reqs)} of {len(reqs)} files written byte-identical, {raw_total} bytes in {dt:.3f} s = "
        f"{gbps:.3f} Gbps from the POST to the last completion; wire bytes {stats['wire_bytes']}, wire reduction "
        f"{raw_total / stats['wire_bytes']:.3f}x, REF segments {stats['ref_segments']} of {stats['segments']} "
        f"({ref_share:.2%}); NACKs {wire['nacks_reaped']}, resends {wire['frames_sent'] - len(reqs)}, stream resets "
        f"{wire['stream_resets']}, streams {wire['streams_open']}; runner launches {launches}; receiver "
        f"verify_counters {verify}; process CPU {cpu_s:.3f} s ({cpu_s / dt:.2f} cores)")
    for gid, fc in compiles.items():
        log(f"phase 6 ({label}): daemon {gid}: phase.first_compile "
            + (f"{fc[0] * 1e3:.3f} ms (bucket {fc[1]}, rows {fc[2]})" if fc else "not journaled"))
    if split is not None:
        log(f"phase 6 ({label}): " + split.summary())
    log(f"phase 6 ({label}): sender wire: ack lag {wire['ack_lag_ns'] / 1e9:.3f} s summed over frames "
        f"({wire['ack_lag_ns'] / 1e9 / max(wire['frames_sent'], 1):.3f} s a frame), wire stall "
        f"{wire['wire_stall_ns'] / 1e9:.3f} s, frames pipelined {wire['frames_pipelined']}; sender device wait "
        f"{stats['device_wait_ns'] / 1e9:.3f} s summed over workers, batch windows {stats['batch_windows']} "
        f"(rows {stats['batch_rows']}); receiver: decode {decode['decode_ns'] / 1e9:.3f} s summed over "
        f"{decode['decode_workers']} decode workers, REF waits {decode['store_ref_wait_ns'] / 1e9:.3f} s, "
        f"store hits {decode['store_mem_hits']}")
    # the destination's runner works only for paranoid verification
    for d in ((src, dst) if paranoid else (src,)):
        counts = launches[d.gateway_id]
        if any(counts.get(k, 0) == 0 for k in SLICE1):
            raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id}'s runner launched no {SLICE1}: {counts}")
    for d in (src, dst):
        if any(launches[d.gateway_id].values()) and compiles[d.gateway_id] is None:
            raise AssertionError(f"phase 6 ({label}): daemon {d.gateway_id}'s runner launched kernels but "
                                 "journaled no phase.first_compile")
    if paranoid and verify["verify_batched"] != len(reqs):
        raise AssertionError(f"phase 6 ({label}): {verify['verify_batched']} of {len(reqs)} recipe chunks "
                             f"re-fingerprinted through the destination's runner: {verify}")
    if prof is not None:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise AssertionError(f"phase 6 ({label}): the traced round recorded no device events")
        busy_us, top = device_busy(events)
        log(f"phase 6 ({label}) on {card}: traced round: wall {dt:.3f} s, device busy {busy_us / 1e3:.3f} ms = "
            f"{busy_us / 1e6 / dt:.2%} of wall (idle {1 - busy_us / 1e6 / dt:.2%}); device time by name (ms): "
            + "; ".join(f"{name[:60]} {us / 1e3:.3f}" for name, us in top))
    return {"gbps": gbps, "ack_lag_s": wire["ack_lag_ns"] / 1e9, "ref_share": ref_share,
            "restore_wall_s": split.wall_ns["recipe_restore"] / 1e9 if split is not None else None}


def gateway_phase(dev, chunks, params, card: str, main_gbps) -> None:
    """Phase 6: the gateway from 24 source files to 24 destination files
    through two port daemons (see the module docstring)."""
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops import kernels

    native_dp._available = True  # the main path's configuration, pass (b)
    shutil.rmtree(GATEWAY_DIR, ignore_errors=True)
    (GATEWAY_DIR / "src").mkdir(parents=True)
    (GATEWAY_DIR / "dst").mkdir(parents=True)
    files = []
    for i, c in enumerate(chunks):
        src = GATEWAY_DIR / "src" / f"chunk{i:02d}.bin"
        src.write_bytes(c)
        files.append((src, GATEWAY_DIR / "dst" / f"chunk{i:02d}.bin"))
    try:
        sync(dev)
        kernels.reset_launch_counts()
        rounds = [gateway_round(dev, files, chunks, params, card, label, paranoid=True) for label in ("1", "2")]
        sync(dev)
        launches = kernels.launch_counts()
        witness = gateway_round(dev, files, chunks, params, card, "witness", paranoid=False)
        gateway_round(dev, files, chunks, params, card, "traced", paranoid=True, trace=True)
    finally:
        shutil.rmtree(GATEWAY_DIR, ignore_errors=True)
    def fmt(r: dict) -> str:
        return (f"{r['gbps']:.3f} Gbps, ack lag {r['ack_lag_s']:.3f} s, REF share {r['ref_share']:.2%}, "
                f"restore wall {r['restore_wall_s']:.3f} s")

    log(f"phase 6 on {card}: paranoid rounds: " + "; ".join(fmt(r) for r in rounds)
        + f"; witness round at the daemon's default (paranoid verify off): {fmt(witness)}"
        + "; phase 3 (b), the sender path alone, in this call: " + ", ".join(f"{g:.3f}" for g in main_gbps)
        + f"; process-wide kernel launches of the two paranoid rounds {launches}")
    if any(launches[k] == 0 for k in SLICE1):
        raise AssertionError(f"a kernel of the gateway path never launched: {launches}")


def device_busy(events):
    """Device events of a profile -> (busy us: the union of their intervals,
    the 8 names with the most device time, as (name, us))."""
    from collections import defaultdict

    busy_us, end_us = 0.0, None
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end_us is None or start > end_us:
            busy_us += stop - start
            end_us = stop
        elif stop > end_us:
            busy_us += stop - end_us
            end_us = stop
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    return busy_us, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def profile_main_path(dev, chunks, params, card: str) -> None:
    """Phase 4: one more pass of the main path (fresh runner and index) under
    torch.profiler: the device's busy share of the wall time (the union of
    its kernel and copy intervals) and device time by kernel or copy name.
    Only the profiler's own failures (it cannot start, or records no device
    activity) are reported as not measured; an error of the data path ends
    the run."""
    from torch.profiler import ProfilerActivity, profile

    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    runner = DeviceBatchRunner(cdc_params=params, max_batch=MAX_BATCH, device=dev)
    proc = DataPathProcessor(codec_name="tpu", dedup=True, cdc_params=params, batch_runner=runner, device=dev)
    index = SenderDedupIndex()
    lock = threading.Lock()

    def one(c: bytes) -> None:
        p = proc.process(c, index)
        with lock:
            for fp, size in p.new_fingerprints:
                index.add(fp, size)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 4: device busy share not measured (profiler did not start: {err!r})")
        prof = None
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=WORKERS) as pool:
            list(pool.map(one, chunks))
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.stop()
    if prof is None:
        return
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        events, why = [], f"profiler events unreadable: {err!r}"
    else:
        why = "no device events traced"
    if not events:
        log(f"phase 4 on {card}: profiled wall {wall:.3f} s; device busy share not measured ({why})")
        return
    busy_us, top = device_busy(events)
    log(f"phase 4 on {card}: profiled wall {wall:.3f} s, device busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / 1e6 / wall:.2%} of wall (idle {1 - busy_us / 1e6 / wall:.2%}); device time by name (ms): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}" for name, us in top))
    per_kernel = {k: [e.time_range.elapsed_us() for e in events if f"{k}_kernel" in e.name] for k in SLICE1}
    log("phase 4: traced device time of the main path's kernels: " + "; ".join(
        f"{k} {sum(v) / 1e3:.4f} ms over {len(v)} launches" for k, v in per_kernel.items()))


def batch_step(dev, chunks, card: str):
    """Phase 5: ``datapath_step`` on the card, its checks, and its kernels
    against their plain versions. Returns (launches, errors, timings, bounds)."""
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.fingerprint import MAX_SEGMENT_BYTES, N_LANES
    from skyplane_tpu_torch.ops.host_fallback import blockpack_decode_host
    from skyplane_tpu_torch.ops.pipeline import datapath_step
    from skyplane_tpu_torch.ops.u32 import M31
    from skyplane_tpu_torch.state import device_tables

    tables = device_tables(dev)
    bucket = CHUNK_MB << 20
    rows = np.stack([np.frombuffer(c, np.uint8) for c in chunks[:MAX_BATCH]])
    batch = torch.from_numpy(rows).to(dev)
    step = dict(block_bytes=STEP_BLOCK, fp_seg_bytes=STEP_FP_SEG, mask_bits=STEP_MASK_BITS)

    sync(dev)
    kernels.reset_launch_counts()
    out = datapath_step(batch, **step)
    sync(dev)
    launches = kernels.launch_counts()
    log(f"phase 5: datapath_step B={MAX_BATCH} N={bucket} {step}: kernel launches {launches}")
    if any(launches[k] == 0 for k in SLICE2):
        raise AssertionError(f"a kernel of the batch step never launched: {launches}")

    # the entry() twin on the card equals its CPU run (plain versions)
    from skyplane_tpu_torch.entry import entry

    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    got, want = fn(*args), fn_cpu(*args_cpu)
    entry_err = max(max_abs_err(got[k].cpu(), want[k]) for k in want)
    if entry_err:
        raise AssertionError(f"entry() on the card differs from its CPU run by {entry_err}")

    # the outputs: shapes, types, ranges, and every row's literals round trip
    want_shapes = {
        "candidates": ((MAX_BATCH, bucket), torch.bool),
        "tags": ((MAX_BATCH, bucket // STEP_BLOCK), torch.uint8),
        "literals": ((MAX_BATCH, bucket), torch.uint8),
        "n_lit": ((MAX_BATCH,), torch.int32),
        "fp_lanes": ((MAX_BATCH, bucket // STEP_FP_SEG, N_LANES), torch.int32),
    }
    for k, (shape, dtype) in want_shapes.items():
        if tuple(out[k].shape) != shape or out[k].dtype != dtype or out[k].device != batch.device:
            raise AssertionError(f"{k}: {out[k].dtype} {tuple(out[k].shape)} on {out[k].device}, want {dtype} {shape}")
    lanes = out["fp_lanes"]
    if int(lanes.min()) < 0 or int(lanes.max()) >= M31:
        raise AssertionError("fp_lanes outside [0, M31)")
    tags_np, lit, n_lit = out["tags"].cpu().numpy(), out["literals"].cpu(), out["n_lit"].cpu().numpy()
    for i in range(MAX_BATCH):
        if not 0 <= n_lit[i] <= bucket or lit[i, n_lit[i]:].any():
            raise AssertionError(f"row {i}: n_lit {n_lit[i]} or a nonzero literal tail")
        back = blockpack_decode_host(tags_np[i], lit[i, : n_lit[i]].numpy(), STEP_BLOCK)
        if not np.array_equal(back, rows[i]):
            raise AssertionError(f"row {i}: literals do not decode to the row")
    tag_counts = np.bincount(tags_np.reshape(-1), minlength=3).tolist()
    n_cand = int(out["candidates"].sum())
    log(f"phase 5: entry() twin on the card equals its CPU run; outputs checked; all {MAX_BATCH} rows decode byte-identical from (tags, literals[:n_lit]); "
        f"tags zero/const/literal {tag_counts}; literal bytes {int(n_lit.sum())} of {MAX_BATCH * bucket}; candidates {n_cand}")

    # each kernel == its plain version: the step's rows, then adversarial rows
    rng = np.random.default_rng(2)
    adv = rows.copy()
    adv[4] = 0
    adv[5] = 0x5A
    adv[6] = np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), bucket // 1024)
    adv[7] = rng.integers(0, 256, bucket, dtype=np.uint8)
    adv_batch = torch.from_numpy(adv).to(dev)
    errs = {k: 0 for k in SLICE2}
    for b in (batch, adv_batch):
        errs["gear_mask"] = max(errs["gear_mask"], max_abs_err(
            kernels.gear_mask(b, tables, STEP_MASK_BITS), kernels.gear_mask_plain(b, tables, STEP_MASK_BITS)))
        errs["segment_fp_fixed"] = max(errs["segment_fp_fixed"], max_abs_err(
            kernels.segment_fp_fixed(b, STEP_FP_SEG, tables), kernels.segment_fp_fixed_plain(b, STEP_FP_SEG, tables)))
        got, want = kernels.blockpack_encode(b, STEP_BLOCK), kernels.blockpack_encode_plain(b, STEP_BLOCK)
        errs["blockpack_encode"] = max([errs["blockpack_encode"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        torch.cuda.empty_cache()
    adv_tags = np.bincount(kernels.blockpack_encode(adv_batch, STEP_BLOCK)[0].cpu().numpy().reshape(-1), minlength=3)
    block_errs = {}
    for bb in STEP_EXTRA_BLOCKS:
        cut = batch[:, : bucket // bb * bb].contiguous()
        got, want = kernels.blockpack_encode(cut, bb), kernels.blockpack_encode_plain(cut, bb)
        block_errs[bb] = max(max_abs_err(g, w) for g, w in zip(got, want))
        del cut, got, want
        torch.cuda.empty_cache()
    flat = torch.empty(batch.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = flat[1:].view(batch.shape)  # a contiguous batch at storage offset 1: no bulk copies
    shifted.copy_(batch)
    got, want = kernels.blockpack_encode(shifted, STEP_BLOCK), kernels.blockpack_encode_plain(batch, STEP_BLOCK)
    block_errs["unaligned"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    del flat, shifted, got, want
    torch.cuda.empty_cache()
    errs["blockpack_encode"] = max([errs["blockpack_encode"]] + list(block_errs.values()))
    stride_errs = {}
    for seg in STEP_EXTRA_STRIDES:
        stride_errs[seg] = max_abs_err(kernels.segment_fp_fixed(batch, seg, tables), kernels.segment_fp_fixed_plain(batch, seg, tables))
        torch.cuda.empty_cache()
    odd = batch[:, : (bucket // STEP_ODD_STRIDE // 8) * 8 * STEP_ODD_STRIDE].contiguous()
    stride_errs[STEP_ODD_STRIDE] = max_abs_err(
        kernels.segment_fp_fixed(odd, STEP_ODD_STRIDE, tables), kernels.segment_fp_fixed_plain(odd, STEP_ODD_STRIDE, tables))
    del odd
    torch.cuda.empty_cache()
    errs["segment_fp_fixed"] = max([errs["segment_fp_fixed"]] + list(stride_errs.values()))
    sync(dev)
    log(f"phase 5: max |kernel - plain| {errs} (step rows and adversarial rows: zero, constant 0x5A, "
        f"repeated 1 KiB, random; their tags zero/const/literal {adv_tags.tolist()}); "
        f"segment_fp_fixed at strides {list(STEP_EXTRA_STRIDES)} and {STEP_ODD_STRIDE} (byte path): {stride_errs}; "
        f"blockpack_encode at blocks {list(STEP_EXTRA_BLOCKS)} and on a batch at storage offset 1: {block_errs}")
    if any(errs.values()) or min(adv_tags) == 0:
        raise AssertionError(f"a batch-step kernel disagrees with its plain version: {errs}, tags {adv_tags.tolist()}")

    # times at the step's shapes; the plain versions are the same arithmetic, no yardstick of speed
    t = {
        "gear_mask": (
            time_ms(lambda: kernels.gear_mask(batch, tables, STEP_MASK_BITS), 50),
            time_ms(lambda: kernels.gear_mask_plain(batch, tables, STEP_MASK_BITS), 3, 1),
        ),
        "segment_fp_fixed": (
            time_ms(lambda: kernels.segment_fp_fixed(batch, STEP_FP_SEG, tables), 50),
            time_ms(lambda: kernels.segment_fp_fixed_plain(batch, STEP_FP_SEG, tables), 3, 1),
        ),
        "blockpack_encode": (
            time_ms(lambda: kernels.blockpack_encode(batch, STEP_BLOCK), 50),
            time_ms(lambda: kernels.blockpack_encode_plain(batch, STEP_BLOCK), 3, 1),
        ),
    }
    torch.cuda.empty_cache()
    stride_ms = {seg: time_ms(lambda: kernels.segment_fp_fixed(batch, seg, tables), 20) for seg in STEP_EXTRA_STRIDES}
    encode_traced = traced_ms(lambda: kernels.blockpack_encode(batch, STEP_BLOCK), "blockpack_encode", 50)
    copy_out = torch.empty_like(batch)
    copy_ms = time_ms(lambda: copy_out.copy_(batch), 50)  # a yardstick: one read and one write of the batch
    del copy_out
    block_ms = {}
    for bb in STEP_EXTRA_BLOCKS:
        cut = batch[:, : bucket // bb * bb].contiguous()
        block_ms[bb] = time_ms(lambda: kernels.blockpack_encode(cut, bb), 20)
        del cut
    torch.cuda.empty_cache()
    step_ms = time_ms(lambda: datapath_step(batch, **step), 20)
    n_in = MAX_BATCH * bucket
    bounds = {
        # read the bytes and the table, write one byte per byte. Per byte: the
        # hash step (one shift-add) and the top-bits test
        "gear_mask": bound_ms(n_in + 1024 + n_in, 2 * n_in),
        # read the bytes, word_limbs and the word_powers rows r^(S-64(k+1))
        # (one per word of a segment), write the lanes. Per word with a
        # nonzero byte: its u8 product and 18 integer instructions a lane
        "segment_fp_fixed": bound_ms(
            n_in + 64 * 32 + 32 * (min(STEP_FP_SEG, MAX_SEGMENT_BYTES) // 64) + 4 * lanes.numel(), *word_work(batch)
        ),
        # read the bytes; write tags, literals (the zero tail too) and n_lit.
        # Per byte: one compare with the block's first
        "blockpack_encode": bound_ms(n_in + out["tags"].numel() + n_in + 4 * MAX_BATCH, n_in),
    }
    for name, (ms, plain_ms) in t.items():
        b, by = bounds[name]
        log(f"  {name}: {ms:.4f} ms/launch (plain {plain_ms:.3f} ms), bound {b:.4f} ms ({by}), {b / ms:.1%} of bound")
    log("  segment_fp_fixed at other strides: " + ", ".join(f"S={seg} {ms:.4f} ms" for seg, ms in stride_ms.items()))
    log(f"  blockpack_encode traced: {encode_traced}; a device-to-device copy of the same {n_in} bytes "
        f"(torch.Tensor.copy_, the byte floor of one read and one write): {copy_ms:.4f} ms; on {card}")
    log("  blockpack_encode at other blocks (rows cut to a multiple): "
        + ", ".join(f"bb={bb} {ms:.4f} ms" for bb, ms in block_ms.items()))
    log(f"phase 5 on {card}: datapath_step {step_ms:.4f} ms per call at B={MAX_BATCH} x {bucket} "
        f"= {n_in / step_ms / 1e6:.2f} GB/s of input")
    profile_step(batch, step, card)
    return launches, errs, t, bounds


def profile_step(batch, step: dict, card: str, reps: int = 20) -> None:
    """Phase 5's trace: ``reps`` steps back to back under torch.profiler; the
    device's busy share of their wall time and device time by kernel. Only
    the profiler's own failures read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    from skyplane_tpu_torch.ops.pipeline import datapath_step

    datapath_step(batch, **step)
    sync(batch.device)
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 5: step trace not measured (profiler did not start: {err!r})")
        return
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            datapath_step(batch, **step)
        sync(batch.device)
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    try:
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as err:  # noqa: BLE001 — the profiler, not the port
        log(f"phase 5: step trace not measured (profiler events unreadable: {err!r})")
        return
    if not events:
        log(f"phase 5: step trace not measured (no device events traced; wall {wall * 1e3 / reps:.4f} ms per step)")
        return
    busy_us, top = device_busy(events)
    log(f"phase 5 on {card}: {reps} steps traced, wall {wall * 1e3 / reps:.4f} ms per step, device busy "
        f"{busy_us / 1e3 / reps:.4f} ms per step = {busy_us / 1e6 / wall:.2%} of wall (idle {1 - busy_us / 1e6 / wall:.2%}); "
        "device time per step by name (ms): " + "; ".join(f"{name[:60]} {us / 1e3 / reps:.4f}" for name, us in top))


def check_builds(kernels) -> None:
    """Phase 1: registers and spills per kernel function from each library's
    ptxas log, and the fingerprint kernels' integer mma instructions (IMMA) in
    their SASS; a fingerprint kernel without one fails."""
    import re
    import shutil

    for name in kernels._KERNELS:
        lib = kernels.library_path(name)
        log_text = lib.with_name(lib.name + ".log").read_text() if lib.with_name(lib.name + ".log").exists() else ""
        regs = re.findall(r"Used (\d+) registers", log_text)
        spills = re.findall(r"(\d+) bytes spill stores", log_text)
        smem = re.findall(r"(\d+) bytes smem", log_text)
        line = f"phase 1: {name}: registers per function {regs}, spill store bytes {spills}, shared memory bytes {smem}"
        if name in ("segment_fp", "segment_fp_fixed"):
            tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            try:
                sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120, check=True).stdout
            except (OSError, subprocess.SubprocessError) as err:
                line += f"; SASS not read ({err!r})"
            else:
                imma = len(re.findall(r"\bIMMA\.", sass))
                line += f"; IMMA instructions in its SASS: {imma}"
                if imma == 0:
                    raise AssertionError(f"{name} issues no integer mma instruction")
        log(line)


def build_native() -> bool:
    """Phase 1: build and load the native host library (fails without it:
    the card's machine has g++, nvcc's host compiler); report liblz4.
    Returns whether the lz4 pass can run."""
    from skyplane_tpu_torch import native
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.utils import lz4ref

    native.load_library()
    if not native_dp.available():
        raise AssertionError("the native host library is not available (SKYPLANE_TPU_NATIVE_DATAPATH opt-out set?)")
    info = native.build_info
    log(f"phase 1: native host library {info['path']}: built in {info['seconds']:.2f} s "
        f"(0.00: found built), -march=native {'took' if info['march_native'] else 'failed: portable build'}")
    if lz4ref.available():
        log("phase 1: lz4ref.available() True (system liblz4)")
    else:
        log("phase 1: lz4ref.available() False: liblz4.so.1 is not present, so the lz4 pass of phase 3 is not measured")
    return lz4ref.available()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from skyplane_tpu_torch.ops import kernels
    from skyplane_tpu_torch.ops.cdc import CDCParams

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: device {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 1: nvidia-smi: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # the host library builds beside the kernels
        host_build = pool.submit(build_native)
        build_s = kernels.build()
        with_lz4 = host_build.result()
    log(f"phase 1: built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s (per kernel: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(build_s.items())) + ")")
    check_builds(kernels)

    t0 = time.perf_counter()
    chunks = make_corpus(SEED)
    raw_total = sum(len(c) for c in chunks)
    log(f"corpus: {len(chunks)} chunks, {raw_total} bytes, made in {time.perf_counter() - t0:.1f} s")
    params = CDCParams()
    errs, timings, bounds = check_kernels(dev, chunks, params)

    launches, main_gbps = main_path(dev, chunks, params, card, with_lz4)
    profile_main_path(dev, chunks, params, card)
    step_launches, step_errs, step_timings, step_bounds = batch_step(dev, chunks, card)
    gateway_phase(dev, chunks, params, card, main_gbps)
    launches.update({k: step_launches[k] for k in SLICE2})
    errs.update(step_errs)
    timings.update(step_timings)
    bounds.update(step_bounds)

    replaces = {
        # the Pallas gear windowed sum, with the XLA compaction of _candidates_impl
        # (skyplane_tpu/ops/fused_cdc.py:91) fused into the same kernel
        "gear_compact": ("skyplane_tpu_torch/csrc/gear_compact.cu", "skyplane_tpu/ops/pallas_kernels.py:48"),
        "segment_fp": ("skyplane_tpu_torch/csrc/segment_fp.cu", "skyplane_tpu/ops/fused_cdc.py:108"),
        "gear_mask": ("skyplane_tpu_torch/csrc/gear_mask.cu", "skyplane_tpu/ops/pallas_kernels.py:48"),
        "segment_fp_fixed": ("skyplane_tpu_torch/csrc/segment_fp_fixed.cu", "skyplane_tpu/ops/pallas_kernels.py:139"),
        "blockpack_encode": ("skyplane_tpu_torch/csrc/blockpack_encode.cu", "skyplane_tpu/ops/blockpack.py:44"),
    }
    rows = []
    for name, (source, rep) in replaces.items():
        ms, plain_ms = timings[name]
        b, by = bounds[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
