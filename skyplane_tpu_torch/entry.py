"""Entry point of the port's flagship step: the twin of ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, args)``: ``fn`` is ``datapath_step`` (gear
CDC candidates, blockpack encode and fixed-stride fingerprints over a batch
of chunks, ``ops/pipeline.py``) at the reference entry's parameters, and
``args`` is the reference entry's example batch (seed 0, row 1 half zero) on
``device``.

``dryrun_multichip(n_devices, device)`` is the twin of
``__graft_entry__.dryrun_multichip``: the SPMD step over an n-position
(data, seq) mesh, then the gateway's meshed ``DeviceBatchRunner`` at the
production shapes through ``DataPathProcessor``, held against the host path.
On the card, position i lies on ``cuda:(i % device_count)``, so one card
runs every mesh shape (its positions one after another); on the CPU every
position is the CPU.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.pipeline import datapath_step
from skyplane_tpu_torch.state import device_tables

BATCH = 2
CHUNK_BYTES = 128 * 1024
BLOCK_BYTES = 512
FP_SEG_BYTES = 64 * 1024
MASK_BITS = 16


def example_batch() -> np.ndarray:
    """The reference entry's input: [2, 128 KiB] uint8, seed 0, row 1's first half zero."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(BATCH, CHUNK_BYTES), dtype=np.uint8)
    x[1, : CHUNK_BYTES // 2] = 0  # exercise the zero-suppression path
    return x


def entry(device="cuda"):
    """Return ``(fn, args)`` for one batch step on ``device`` ("cuda" by default)."""
    dev = resolve_device(device)
    tables = device_tables(dev)

    def fn(batch_u8: torch.Tensor):
        return datapath_step(
            batch_u8, block_bytes=BLOCK_BYTES, fp_seg_bytes=FP_SEG_BYTES, mask_bits=MASK_BITS, tables=tables
        )

    return fn, (torch.from_numpy(example_batch()).to(dev),)


PROD_CHUNK = 8 << 20  # the gateway's deployed chunk
PROD_BATCH = 8  # its batch window


def mesh_devices(n: int, device="cuda") -> list:
    """``n`` mesh positions on ``device``'s kind: ``cuda:(i % device_count)``
    on the card (a position repeats a card when there are fewer cards than
    positions), the CPU ``n`` times on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def host_wire(chunk: bytes, index, codec, params):
    """What ``DataPathProcessor.process`` sends for ``chunk`` with dedup on,
    computed on the host path (CDC and fingerprints by ``cdc_and_fps_host``,
    no device). Returns (wire bytes, REF segments, new fingerprints)."""
    from skyplane_tpu_torch.ops.cdc import cdc_and_fps_host
    from skyplane_tpu_torch.ops.dedup import build_recipe

    ends, fps = cdc_and_fps_host(np.frombuffer(chunk, np.uint8), params)
    starts = np.concatenate([[0], ends[:-1]])
    segments = [(fp, chunk[s:e]) for fp, s, e in zip(fps, starts.tolist(), ends.tolist())]
    wire, n_ref, _, new_fps, _ = build_recipe(segments, index, codec.encode)
    return wire, n_ref, new_fps


def dryrun_multichip(n_devices: int, device="cuda", prod_chunk: int = PROD_CHUNK) -> dict:
    """Run the SPMD step over an ``n_devices`` mesh, then the production
    stage, and print the reference's ``{"metric": "multichip", ...}`` line.

    Stage 1 (the reference's shapes): the step at fingerprint stride 2048,
    block 256, two strides per seq shard, two chunks per data row, mask bits
    10, equal to ``datapath_step`` on the same rows; then a meshed
    ``DeviceBatchRunner`` equal to the host path on a 256 KiB chunk.
    Production stage: ``PROD_BATCH`` chunks of ``prod_chunk`` bytes (8 MiB,
    the gateway's) with default ``CDCParams`` through ``DataPathProcessor``
    with codec ``tpu`` (blockpack; the reference's ``tpu_zstd`` needs
    zstandard, which the card's machine lacks) and dedup over a meshed
    runner (window ``PROD_BATCH``), from ``PROD_BATCH`` threads as gateway
    workers submit; every chunk's wire bytes must equal the host path's, and
    a near-duplicate after the index commits must carry REF segments.

    Returns the line's fields and each runner's kernel launches per position.
    """
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_segment_ends
    from skyplane_tpu_torch.ops.codecs import get_codec
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.fingerprint import segment_fingerprints_host_batch
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor
    from skyplane_tpu_torch.parallel.datapath_spmd import Mesh, make_spmd_datapath

    data = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    seq = n_devices // data
    mesh = Mesh(mesh_devices(n_devices, device), (data, seq))
    dev0 = mesh.devices[0]

    fp_seg, block, mask_bits = 2048, 256, 10
    chunk_bytes = seq * fp_seg * 2  # two fp segments per seq shard
    batch = data * 2
    step = make_spmd_datapath(mesh, chunk_bytes, batch, block_bytes=block, fp_seg_bytes=fp_seg, mask_bits=mask_bits)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(batch, chunk_bytes), dtype=np.uint8)
    out = step(torch.from_numpy(x))
    ref = datapath_step(torch.from_numpy(x).to(dev0), block_bytes=block, fp_seg_bytes=fp_seg, mask_bits=mask_bits)
    for k in ("candidates", "tags", "fp_lanes"):
        if not torch.equal(out[k], ref[k]):
            raise AssertionError(f"stage 1: the sharded step's {k} differ from datapath_step")
    n_lit = out["n_lit"].sum(1, dtype=torch.int32)
    if not torch.equal(n_lit, ref["n_lit"]):
        raise AssertionError("stage 1: the sharded step's literal counts differ from datapath_step")
    n_lit_total = int(n_lit.sum())

    cdc = CDCParams()
    runner = DeviceBatchRunner(cdc_params=cdc, max_batch=batch, mesh=mesh, device=dev0)
    chunk = rng.integers(0, 256, size=256 * 1024, dtype=np.uint8)
    ends, fps = runner.cdc_and_fps(chunk, chunk)  # already a power-of-two bucket
    want_ends = cdc_segment_ends(chunk, cdc)
    if not np.array_equal(ends, want_ends) or fps != segment_fingerprints_host_batch(chunk, want_ends):
        raise AssertionError("stage 1: the meshed runner's boundaries or fingerprints diverge from the host path")
    print(
        f"dryrun stage 1 OK: mesh=({data}x{seq}) on {[str(d) for d in mesh.devices]}, batch={batch}, "
        f"chunk={chunk_bytes}B, literals={n_lit_total}; DeviceBatchRunner validated on mesh "
        f"({len(want_ends)} segments bit-identical)",
        flush=True,
    )

    # the production shapes: a fresh runner at the gateway's window, which
    # at batch >= positions shards over every mesh axis
    prod_runner = DeviceBatchRunner(cdc_params=cdc, max_batch=PROD_BATCH, mesh=mesh, device=dev0)
    corpus = []
    base = rng.integers(0, 256, prod_chunk, dtype=np.uint8)
    for i in range(PROD_BATCH):
        c = base.copy()
        c[i * 65536 : i * 65536 + 32768] = rng.integers(0, 256, 32768, dtype=np.uint8)  # clustered writes
        c[prod_chunk // 2 : prod_chunk // 2 + (256 << 10)] = 0  # zero extent
        corpus.append(c.tobytes())
    near_dup = bytearray(corpus[0])
    near_dup[1000:1100] = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    near_dup = bytes(near_dup)

    # the host path; an EMPTY index makes the batch's recipes order-independent
    codec = "tpu"
    spec = get_codec(codec)
    index = SenderDedupIndex()
    host = [host_wire(c, index, spec, cdc) for c in corpus]
    for _, _, new in host:
        for fp_, size in new:
            index.add(fp_, size)
    host_dup = host_wire(near_dup, index, spec, cdc)

    # the device path, from PROD_BATCH threads (one window), as gateway workers submit
    proc = DataPathProcessor(codec_name=codec, dedup=True, cdc_params=cdc, batch_runner=prod_runner, device=dev0)
    index = SenderDedupIndex()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=PROD_BATCH) as pool:
        payloads = list(pool.map(lambda c: proc.process(c, index), corpus))
    wall = time.perf_counter() - t0
    for p in payloads:
        for fp_, size in p.new_fingerprints:
            index.add(fp_, size)
    dup = proc.process(near_dup, index)
    for i, (h, d) in enumerate(zip(host, payloads)):
        if d.wire_bytes != h[0]:
            raise AssertionError(f"prod chunk {i}: sharded wire bytes diverge from the host path")
    if dup.wire_bytes != host_dup[0]:
        raise AssertionError("near-dup recipe diverges from the host path")
    if dup.n_ref_segments == 0:
        raise AssertionError("near-duplicate produced no REF segments (dedup inactive?)")
    print(
        f"dryrun_multichip OK: mesh=({data}x{seq}); PRODUCTION shapes validated — DataPathProcessor "
        f"(recipe+codec {codec}) on mesh at chunk={prod_chunk >> 20}MiB, batch={PROD_BATCH}, "
        f"cdc avg/max={cdc.avg_bytes >> 10}K/{cdc.max_bytes >> 10}K: {len(corpus)} chunks + near-dup "
        f"({dup.n_ref_segments}/{dup.n_segments} REF segments) bit-identical to host pipeline",
        flush=True,
    )
    line = {
        "metric": "multichip",
        "n_devices": n_devices,
        "mesh": f"{data}x{seq}",
        "prod_chunk_mb": prod_chunk >> 20,
        "prod_batch": PROD_BATCH,
        "ref_segments": int(dup.n_ref_segments),
        "bit_identical": True,
    }
    print(json.dumps(line), flush=True)
    return dict(
        line,
        devices=[str(d) for d in mesh.devices],
        prod_window_s=wall,
        stage1_launches=runner.fused.position_launch_counts(),
        prod_launches=prod_runner.fused.position_launch_counts(),
        prod_counters=prod_runner.counters(),
    )
