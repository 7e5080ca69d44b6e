"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs an NVIDIA GPU and nvcc and skips elsewhere
(the decision is made in a fixture, never at import). Run on a machine with
a card, without the repo's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Equality is exact: every output is an integer.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from skyplane_tpu_torch.ops import kernels
from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_and_fps_host, select_boundaries
from skyplane_tpu_torch.ops.fused_cdc import FusedCDCFP, candidate_cap, slots_cap
from skyplane_tpu_torch.state import device_tables

pytestmark = pytest.mark.cuda

PARAMS = CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    try:
        kernels._nvcc()
    except RuntimeError as e:  # no toolkit: the kernels cannot exist here
        pytest.skip(str(e))
    kernels.build()  # a source that does not compile fails every test here
    return torch.device("cuda", torch.cuda.current_device())


def _batch(rng, b, bucket, lens):
    data = rng.integers(0, 256, (b, bucket), dtype=np.uint8)
    for i, n in enumerate(lens):
        data[i, n:] = 0
    data[0, 1000:9000] = 0  # a zero extent inside a full row
    return data


def _ends_slots(packed, lens, bucket, params, cap):
    n_slots = slots_cap(bucket, params)
    ends = np.full((len(lens), n_slots), bucket, np.int32)
    for i, n in enumerate(lens):
        e = select_boundaries(packed[i, : packed[i, cap]].astype(np.int64), int(n), params)
        ends[i, : len(e)] = e
        if n < bucket:
            ends[i, len(e)] = bucket
    return ends


@pytest.mark.parametrize("bucket", [1 << 16, 1 << 18])
def test_kernels_match_plain(dev, bucket):
    rng = np.random.default_rng(bucket)
    lens = [bucket, bucket // 3, 0, 17]
    data = _batch(rng, 4, bucket, lens)
    cpu_t, gpu_t = device_tables("cpu"), device_tables(dev)
    batch = torch.from_numpy(data)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    for cap in (16, candidate_cap(bucket, PARAMS)):  # 16: overflow rows keep the true count
        packed = kernels.gear_compact(batch.to(dev), lens_t.to(dev), gpu_t, PARAMS.mask_bits, cap)
        torch.cuda.synchronize()
        assert torch.equal(packed.cpu(), kernels.gear_compact(batch, lens_t, cpu_t, PARAMS.mask_bits, cap))
    cap = candidate_cap(bucket, PARAMS)
    packed = kernels.gear_compact(batch, lens_t, cpu_t, PARAMS.mask_bits, cap).numpy()
    ends = torch.from_numpy(_ends_slots(packed, lens, bucket, PARAMS, cap))
    lanes = kernels.segment_fp(batch.to(dev), ends.to(dev), gpu_t)
    assert torch.equal(lanes.cpu(), kernels.segment_fp(batch, ends, cpu_t))


def _gear_compact_plain_rows(batch, lens, tables, mask_bits, caps, step=8):
    """The plain version, 8 rows at a time (its int64 hashes of 64 rows of
    8 MiB would take tens of GB), for every cap from one mask."""
    outs = {cap: [] for cap in caps}
    for i in range(0, batch.shape[0], step):
        mask, _ = kernels.gear_candidates_plain(batch[i : i + step], lens[i : i + step], tables, mask_bits)
        for cap in caps:
            outs[cap].append(kernels.compact_candidates_plain(mask, batch.shape[1], cap))
        del mask
    return {cap: torch.cat(v) for cap, v in outs.items()}


@pytest.mark.parametrize("rows", [1, 8, 64])
@pytest.mark.parametrize("bucket", [1 << 16, 1 << 18, 1 << 23])
def test_gear_compact_matches_plain(dev, bucket, rows):
    """K-AB against its plain version: mask_bits 4 (dense: the cap is hit
    mid-tile), 8 and 14; caps 16, the first row's exact count and the
    gateway's default; rows cut short, empty, and with a zero extent."""
    rng = np.random.default_rng(bucket + rows)
    lens = rng.integers(0, bucket + 1, rows).astype(np.int32)
    lens[0] = bucket
    lens[rows // 2] = 0
    data = torch.from_numpy(rng.integers(0, 256, (rows, bucket), dtype=np.uint8)).to(dev)
    data[-1, 1000:9000] = 0
    lens_t = torch.from_numpy(lens).to(dev)
    tables = device_tables(dev)
    for mask_bits in (4, 8, 14):
        count = int(kernels.gear_compact(data[:1], lens_t[:1], tables, mask_bits, 1)[0, 1])
        caps = sorted({16, max(1, count), candidate_cap(bucket, CDCParams())})
        want = _gear_compact_plain_rows(data, lens_t, tables, mask_bits, caps)
        for cap in caps:
            got = kernels.gear_compact(data, lens_t, tables, mask_bits, cap)
            torch.cuda.synchronize()
            assert torch.equal(got, want[cap]), (mask_bits, cap)
        torch.cuda.empty_cache()


@pytest.mark.parametrize("mask_bits", [4, 14])
def test_gear_compact_repeats_bit_equal(dev, mask_bits):
    """The same launch 20 times gives bit-equal outputs: tiles run in a
    different order each time, so a race in the look-back would show."""
    rng = np.random.default_rng(mask_bits)
    bucket = 1 << 23
    data = torch.from_numpy(rng.integers(0, 256, (8, bucket), dtype=np.uint8)).to(dev)
    lens = torch.full((8,), bucket, dtype=torch.int32, device=dev)
    tables = device_tables(dev)
    cap = candidate_cap(bucket, CDCParams())
    first = kernels.gear_compact(data, lens, tables, mask_bits, cap)
    for _ in range(20):
        assert torch.equal(kernels.gear_compact(data, lens, tables, mask_bits, cap), first)
    assert torch.equal(first, _gear_compact_plain_rows(data, lens, tables, mask_bits, [cap])[cap])


def _adversarial_ends(case, rng):
    """Rows and ends for K-C's word design: its whole, clamped, split and
    byte-by-byte words."""
    if case == "garbage":  # nonzero bytes past n (the garbage slot), a garbage segment past MAX_SEGMENT_BYTES
        bucket = 1 << 19
        data = rng.integers(0, 256, (2, bucket), dtype=np.uint8)
        ends = np.full((2, 8), bucket, np.int32)
        ends[0, :3] = [5000, 9000, 10000]  # then the garbage end `bucket`
        ends[1, :1] = [0]
    elif case == "residues":  # an end at every residue mod 64, ends 1 byte apart, at 64k - 1, 64k, 64k + 1
        bucket = 1 << 18
        data = rng.integers(0, 256, (2, bucket), dtype=np.uint8)
        e = sorted({64 * (61 * k + 5) + k for k in range(64)} | {4095, 4096, 4097, 9000, 9001, 9002, 200001})
        ends = np.full((2, 80), bucket, np.int32)
        ends[:, : len(e)] = e
        ends[1, len(e)] = bucket - 1
    elif case == "all_ff":  # the largest limb sums
        bucket = 1 << 18
        data = np.full((2, bucket), 0xFF, np.uint8)
        ends = np.full((2, 40), bucket, np.int32)
        ends[0, :30] = np.sort(rng.choice(np.arange(1, bucket), 30, replace=False))
    elif case == "segment_2_19":  # a random row with one segment of 2^19 bytes: its head clamped
        bucket = 1 << 20
        data = rng.integers(0, 256, (1, bucket), dtype=np.uint8)
        ends = np.full((1, 8), bucket, np.int32)
        ends[0, :3] = [333, 333 + (1 << 19), 334 + (1 << 19)]
    elif case == "bucket_only":  # the bucket as the only end
        bucket = 1 << 18
        data = rng.integers(0, 256, (2, bucket), dtype=np.uint8)
        ends = np.full((2, 4), bucket, np.int32)
    return data, ends


@pytest.mark.parametrize("case", ["garbage", "residues", "all_ff", "segment_2_19", "bucket_only"])
def test_segment_fp_garbage_and_clipped_positions(dev, case):
    """Garbage and clipped positions, and the adversarial rows of the word
    design: ends at every residue mod 64 (and 1 byte apart), all 0xFF, a
    segment of 2^19 bytes, the bucket as the only end."""
    data, ends = _adversarial_ends(case, np.random.default_rng(7))
    cpu_t, gpu_t = device_tables("cpu"), device_tables(dev)
    batch, e = torch.from_numpy(data), torch.from_numpy(ends)
    got = kernels.segment_fp(batch.to(dev), e.to(dev), gpu_t).cpu()
    assert torch.equal(got, kernels.segment_fp(batch, e, cpu_t))


def test_kernel_launches_counted(dev):
    kernels.reset_launch_counts()
    fused = FusedCDCFP(PARAMS, device=dev)
    rng = np.random.default_rng(3)
    chunk = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    (ends, fps), = fused(chunk[None, :], [len(chunk)])
    want = {name: 0 for name in kernels.launch_counts()}
    want.update(gear_compact=1, segment_fp=1)
    assert kernels.launch_counts() == want
    want_ends, want_fps = cdc_and_fps_host(chunk, PARAMS)
    np.testing.assert_array_equal(ends, want_ends)
    assert fps == want_fps


def test_processor_on_card_matches_cpu(dev):
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, 300_000, dtype=np.uint8)
    near = base.copy()
    near[100_000:100_500] = 7
    chunks = [base.tobytes(), near.tobytes(), rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes()]
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, device=dev)
    gpu = DataPathProcessor(codec_name="tpu", cdc_params=PARAMS, batch_runner=runner, device=dev)
    cpu = DataPathProcessor(codec_name="tpu", cdc_params=PARAMS, device="cpu")
    gi, ci = SenderDedupIndex(), SenderDedupIndex()
    for c in chunks:
        a, b = gpu.process(c, gi), cpu.process(c, ci)
        assert a.wire_bytes == b.wire_bytes
        for fp, size in a.new_fingerprints:
            gi.add(fp, size)
        for fp, size in b.new_fingerprints:
            ci.add(fp, size)


def test_main_path_native_on_card_matches_cpu(dev):
    """8 MiB chunks through the card's main path with codec ``native_lz`` (the
    native library on the host side): wire bytes equal the CPU run's, and
    both restore byte-identical under paranoid verify."""
    import uuid

    from skyplane_tpu_torch.chunk import ChunkFlags, WireProtocolHeader
    from skyplane_tpu_torch.native import datapath as native_dp
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
    from skyplane_tpu_torch.ops.dedup import SegmentStore, SenderDedupIndex
    from skyplane_tpu_torch.ops.pipeline import DataPathProcessor

    assert native_dp.available(), "the native library did not build"
    rng = np.random.default_rng(12)
    base = rng.integers(0, 256, 8 << 20, dtype=np.uint8)
    base[1 << 20 : 3 << 20] = 0
    near = base.copy()
    near[5 << 20 : (5 << 20) + 40_000] = rng.integers(0, 256, 40_000, dtype=np.uint8)
    chunks = [base.tobytes(), near.tobytes(), rng.integers(0, 256, (8 << 20) - 4097, dtype=np.uint8).tobytes()]
    runner = DeviceBatchRunner(max_batch=4, device=dev)
    out = {}
    for name, proc in (
        ("cuda", DataPathProcessor(codec_name="native_lz", batch_runner=runner, device=dev)),
        ("cpu", DataPathProcessor(codec_name="native_lz", device="cpu")),
    ):
        index = SenderDedupIndex()
        out[name] = []
        for c in chunks:
            p = proc.process(c, index)
            for fp, size in p.new_fingerprints:
                index.add(fp, size)
            out[name].append(p)
    assert [p.wire_bytes for p in out["cuda"]] == [p.wire_bytes for p in out["cpu"]]
    assert out["cuda"][1].n_ref_segments > 0
    for name, receiver in (
        ("cuda", DataPathProcessor(codec_name="native_lz", batch_runner=runner, paranoid_verify=True, device=dev)),
        ("cpu", DataPathProcessor(codec_name="native_lz", paranoid_verify=True, device="cpu")),
    ):
        store = SegmentStore()
        for c, p in zip(chunks, out[name]):
            header = WireProtocolHeader(
                chunk_id=uuid.uuid4().hex, data_len=len(p.wire_bytes), raw_data_len=p.raw_len, codec=int(p.codec),
                flags=int(ChunkFlags.RECIPE), fingerprint=p.fingerprint,
            )
            assert receiver.restore(p.wire_bytes, header, store) == c
        batched = len(chunks) if name == "cuda" else 0
        assert receiver.verify_counters() == {"verify_total": len(chunks), "verify_batched": batched}


# ---- the batch step's kernels: K-A' gear_mask, K-D segment_fp_fixed, K-E blockpack_encode ----


def _step_rows(rng, n, block=512):
    """Random, all-zero, constant, repeated 1 KiB pattern, and mixed blocks."""
    rows = np.stack([rng.integers(0, 256, n, dtype=np.uint8) for _ in range(5)])
    rows[1] = 0
    rows[2] = 0x5A
    rows[3] = np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), -(-n // 1024))[:n]
    blocks = rows[4].reshape(-1, block)
    pick = rng.integers(0, 3, len(blocks))
    blocks[pick == 0] = 0
    blocks[pick == 1] = 7
    return rows


@pytest.mark.parametrize("n, mask_bits", [(1 << 17, 12), (3 * 4096, 8), (8192 + 40, 6)])
def test_gear_mask_matches_plain(dev, n, mask_bits):
    batch = torch.from_numpy(_step_rows(np.random.default_rng(n), n, 8))
    got = kernels.gear_mask(batch.to(dev), device_tables(dev), mask_bits)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool
    assert torch.equal(got.cpu(), kernels.gear_mask(batch, device_tables("cpu"), mask_bits))


@pytest.mark.parametrize(
    "n, seg",
    [(1 << 18, 4096), (1 << 18, 1 << 16), (1 << 20, 1 << 17), (1 << 20, 1 << 19), (64000, 1000), (12288, 3),
     (1 << 16, 64), (3 << 16, 192)],
)
def test_segment_fp_fixed_matches_plain(dev, n, seg):
    """Strides inside and outside the Pallas domain, the clamp past 2^18,
    strides of one and three words (the word path with a segment change
    inside every warp pass), and strides that force the kernel's byte path
    (not a multiple of 64)."""
    batch = torch.from_numpy(_step_rows(np.random.default_rng(seg), n, 64 if n % 512 else 512))
    got = kernels.segment_fp_fixed(batch.to(dev), seg, device_tables(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.segment_fp_fixed(batch, seg, device_tables("cpu")))


BIG_BLOCK = kernels.BLOCKPACK_TILE + 8192  # larger than a tile: one block per tile, streamed twice


def _encode_equal(batch_cpu, block, dev, batch_dev=None):
    """K-E on the card (one launch) == its plain version on the CPU."""
    kernels.reset_launch_counts()
    got = kernels.blockpack_encode(batch_cpu.to(dev) if batch_dev is None else batch_dev, block)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blockpack_encode"] == 1
    want = kernels.blockpack_encode(batch_cpu, block)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize(
    "n, block",
    [(1 << 18, 512), (1 << 18, 4096), (12000, 600), (4096, 4), (1 << 16, 1), (1 << 18, 16), (3 * BIG_BLOCK, BIG_BLOCK),
     (8200, 8), (100024, 8), (3 * (BIG_BLOCK + 8), BIG_BLOCK + 8), (70000, 7)],
)
def test_blockpack_encode_matches_plain(dev, n, block):
    """Blocks of 1 to beyond a tile, a block that is not a power of two, and
    rows whose length is not a multiple of 16 (byte loads instead of the
    bulk copy, every literal run at another alignment)."""
    _encode_equal(torch.from_numpy(_step_rows(np.random.default_rng(block), n, block)), block, dev)


@pytest.mark.parametrize("block", [1, 16, 512, BIG_BLOCK])
def test_blockpack_encode_unaligned_batch(dev, block):
    """A contiguous batch whose data pointer is not 16-byte aligned (a view at
    storage offset 1)."""
    rows = _step_rows(np.random.default_rng(block + 1), 3 * BIG_BLOCK, block)
    flat = torch.empty(rows.size + 1, dtype=torch.uint8, device=dev)
    view = flat[1:].view(rows.shape)
    view.copy_(torch.from_numpy(rows))
    assert view.is_contiguous() and view.data_ptr() % 16 == 1
    _encode_equal(torch.from_numpy(rows), block, dev, batch_dev=view)


@pytest.mark.parametrize("kind", ["zero", "literal"])
@pytest.mark.parametrize("block", [1, 512, BIG_BLOCK])
def test_blockpack_encode_all_zero_and_all_literal(dev, kind, block):
    """n_lit 0 (every output byte from the zero ranges) and n_lit = n for
    blocks of more than one byte (every byte from the literal runs)."""
    n = 3 * BIG_BLOCK
    rng = np.random.default_rng(block)
    rows = np.zeros((4, n), np.uint8) if kind == "zero" else rng.integers(1, 256, (4, n), dtype=np.uint8)
    if kind == "literal" and block > 1:
        rows.reshape(4, -1, block)[:, :, 0] ^= 0x80  # no block is constant
    _encode_equal(torch.from_numpy(rows), block, dev)


def test_blockpack_encode_repeats_equal_plain(dev):
    """20 launches at B = 8 x 8 MiB, bb 512, all equal to the plain version:
    tiles run in another order each launch, so a race in the look-back or
    the mirrored zero ranges would show."""
    n = 1 << 23
    rows = np.concatenate([_step_rows(np.random.default_rng(9), n, 512), _step_rows(np.random.default_rng(10), n, 512)[:3]])
    batch = torch.from_numpy(rows).to(dev)
    want = kernels.blockpack_encode_plain(batch, 512)
    kernels.reset_launch_counts()
    for _ in range(20):
        got = kernels.blockpack_encode(batch, 512)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert kernels.launch_counts()["blockpack_encode"] == 20


def test_datapath_step_on_card_matches_cpu(dev):
    from skyplane_tpu_torch.ops.pipeline import datapath_step

    batch = torch.from_numpy(_step_rows(np.random.default_rng(2), 1 << 18))
    kernels.reset_launch_counts()
    got = datapath_step(batch.to(dev), block_bytes=512, fp_seg_bytes=1 << 16, mask_bits=16)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["gear_mask"], counts["blockpack_encode"], counts["segment_fp_fixed"]) == (1, 1, 1)
    want = datapath_step(batch, block_bytes=512, fp_seg_bytes=1 << 16, mask_bits=16, tables=device_tables("cpu"))
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_entry_twin_on_card(dev):
    from skyplane_tpu_torch.entry import entry

    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    got, want = fn(*args), fn_cpu(*args_cpu)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_gateway_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The port's serial sender frames the same bytes with its runner on the
    card as on the CPU, and a pair of port daemons on the card, each building
    its own runner (paranoid verify on), lands every file byte-identical,
    launching K-AB and K-C on each daemon's runner and journaling each
    runner's ``phase.first_compile``."""
    from skyplane_tpu_torch.obs.events import PH_FIRST_COMPILE
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

    # loaded by path: the card's machine has another top-level ``tests`` package
    spec = importlib.util.spec_from_file_location("torch_gateway_util", Path(__file__).with_name("torch_gateway_util.py"))
    util = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(util)
    run_sender, write_sources = util.run_sender, util.write_sources
    rng = np.random.default_rng(77)
    base = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    datas = [base, rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(), base, base[:150_000] + bytes(60_000)]
    frames = []
    for d in (torch.device("cpu"), dev):
        runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=8, device=d)
        frames.append(run_sender(
            "port", tmp_path, datas, codec_name="tpu", dedup=True, pipelined=False, max_streams=1,
            window=len(datas), cdc_params=PARAMS, batch_runner=runner, device=d,
        ))
    assert frames[0] == frames[1], "the card's frames differ from the CPU's"

    monkeypatch.setenv("SKYPLANE_TPU_PARANOID_VERIFY", "1")
    monkeypatch.setenv("SKYPLANE_TPU_DECODE_WORKERS", "2")
    files = write_sources(tmp_path / "pair", datas)
    side = {"cdc_params": PARAMS, "device": dev}
    src, dst = util.make_pair(tmp_path / "pair" / "gw", compress="tpu", dedup=True, src_kw=side, dst_kw=side)
    try:
        util.wait_complete(dst, util.dispatch(src, files))
        verify = dst.daemon.receiver.processor.verify_counters()
        events = src.get("events", params={"since": 0}, timeout=10).json()["events"]
    finally:
        util.stop_all(src, dst)
    for (_, dest, _), data in zip(files, datas):
        assert dest.read_bytes() == data
    assert verify["verify_batched"] == verify["verify_total"] == len(files)
    for gw in (src, dst):
        counts = gw.daemon.batch_runner.fused.launch_counts()
        assert counts.get("gear_compact", 0) > 0 and counts.get("segment_fp", 0) > 0, counts
        edges = sorted(e["edge"] for e in events if e["kind"] == PH_FIRST_COMPILE and e.get("gateway") == gw.daemon.gateway_id)
        assert edges == ["end", "start"], (gw.daemon.gateway_id, edges)



# ---- the SPMD step (K-A' with a halo, a mesh of positions) ----


def _halo_with_candidate(first: int, mask_bits: int, rng) -> np.ndarray:
    """32 halo bytes that put a candidate on a shard whose first byte is
    ``first``: h_0 = G[first] + sum_k G[halo[32 - k]] << k for k in 1..31."""
    from skyplane_tpu_torch.ops.gear import GEAR_TABLE

    g = GEAR_TABLE.astype(np.uint64)
    while True:
        halos = rng.integers(0, 256, (1 << 16, 32), dtype=np.uint8)
        h = np.full(len(halos), g[first], np.uint64)
        for k in range(1, 32):
            h += g[halos[:, 32 - k]] << np.uint64(k)
        hit = np.flatnonzero(((h & np.uint64(0xFFFFFFFF)) >> np.uint64(32 - mask_bits)) == 0)
        if len(hit):
            return halos[hit[0]]


@pytest.mark.parametrize("n, mask_bits", [(1 << 17, 12), (8192 + 40, 6)])
def test_gear_mask_halo_matches_plain(dev, n, mask_bits):
    """K-A' with a halo == its plain version: random halos, a shard boundary
    inside a run of equal bytes, and a candidate on the shard's first byte."""
    rng = np.random.default_rng(n + mask_bits)
    rows = _step_rows(rng, n, 8)
    halo = rng.integers(0, 256, (len(rows), 32), dtype=np.uint8)
    halo[1] = 0  # with rows[1] all zero: a boundary inside a run of zeros
    halo[2] = 0x5A  # with rows[2] constant 0x5A
    halo[3] = _halo_with_candidate(int(rows[3, 0]), mask_bits, rng)  # a candidate on the shard's first byte
    cpu_t, gpu_t = device_tables("cpu"), device_tables(dev)
    plain = kernels.gear_mask_plain(torch.from_numpy(rows), cpu_t, mask_bits, torch.from_numpy(halo))
    assert bool(plain[3, 0])
    kernels.reset_launch_counts()
    got = kernels.gear_mask(torch.from_numpy(rows).to(dev), gpu_t, mask_bits, halo=torch.from_numpy(halo).to(dev))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gear_mask_halo"] == 1
    assert torch.equal(got.cpu(), plain)


def test_spmd_step_on_one_card_matches_datapath_step(dev):
    """The step over four positions on one card ([cuda:0] * 4, 2x2) equals
    ``datapath_step`` on the same rows; three launches a position."""
    from skyplane_tpu_torch.ops.pipeline import datapath_step
    from skyplane_tpu_torch.parallel.datapath_spmd import Mesh, make_spmd_datapath

    rows = _step_rows(np.random.default_rng(5), 1 << 18)[:4]
    mesh = Mesh([dev] * 4, (2, 2))
    step = make_spmd_datapath(mesh, 1 << 18, 4, block_bytes=512, fp_seg_bytes=1 << 16, mask_bits=16)
    kernels.reset_launch_counts()
    out = step(torch.from_numpy(rows).to(dev))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["gear_mask"], counts["gear_mask_halo"], counts["blockpack_encode"], counts["segment_fp_fixed"]) == (4, 2, 4, 4)
    want = datapath_step(torch.from_numpy(rows).to(dev), block_bytes=512, fp_seg_bytes=1 << 16, mask_bits=16)
    for k in ("candidates", "tags", "fp_lanes"):
        assert torch.equal(out[k], want[k]), k
    assert torch.equal(out["n_lit"].sum(1, dtype=torch.int32), want["n_lit"])


def test_launch_on_another_card_keeps_the_current_device(dev):
    """A launch on the last card leaves the thread's current device where it was."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more cards, the machine has {n}")
    last = torch.device("cuda", n - 1)
    before = torch.cuda.current_device()
    batch = torch.from_numpy(_step_rows(np.random.default_rng(1), 1 << 16)).to(last)
    got = kernels.gear_mask(batch, device_tables(last), 12)
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == before
    assert torch.empty(1, device="cuda").device.index == before
    assert torch.equal(got.cpu(), kernels.gear_mask(batch.cpu(), device_tables("cpu"), 12))
