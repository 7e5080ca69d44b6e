"""The port's sender and receiver data path against the JAX package's, on the CPU.

``FusedCDCFP``, ``DeviceBatchRunner`` and ``DataPathProcessor`` run with
``device="cpu"`` (the same path the card runs, through the kernels' plain
versions) and must give the JAX package's segment ends, digests and wire
bytes exactly; each package restores the other's wire bytes. Also checks
that the port imports neither jax nor the JAX package.
"""

import ast
import subprocess
import sys
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from skyplane_tpu.ops import cdc as jcdc
from skyplane_tpu.ops import dedup as jdedup
from skyplane_tpu.ops import pipeline as jpipeline
from skyplane_tpu.chunk import WireProtocolHeader as JWireProtocolHeader
from skyplane_tpu_torch import state
from skyplane_tpu_torch.chunk import ChunkFlags, Codec, WireProtocolHeader
from skyplane_tpu_torch.ops import blockpack, fused_cdc
from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.bufpool import BufferPool
from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_and_fps_host
from skyplane_tpu_torch.ops.dedup import SegmentStore, SenderDedupIndex
from skyplane_tpu_torch.ops.pipeline import DataPathProcessor, effective_codec_name

REPO = Path(__file__).resolve().parents[1]
PARAMS = CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)
JPARAMS = jcdc.CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)


def _pad(arr, bucket):
    out = np.zeros(bucket, np.uint8)
    out[: len(arr)] = arr
    return out


def _mini_corpus(seed=0, n_chunks=3, chunk_bytes=200_000, snapshots=2):
    """Snapshot chain in the bench's shape, small: structured content with
    zero extents, then each snapshot rewrites a few clustered 4 KiB runs of
    the previous one (near-duplicates that carry REF segments)."""
    rng = np.random.default_rng(seed)
    snap = []
    for _ in range(n_chunks):
        c = rng.integers(0, 256, chunk_bytes, dtype=np.uint8)
        c[rng.integers(0, chunk_bytes - 30_000) :][:30_000] = 0
        rec = rng.integers(0, 256, 64, dtype=np.uint8)
        start = int(rng.integers(0, chunk_bytes - 40_000))
        c[start : start + 40_000] = np.tile(rec, 40_000 // 64 + 1)[:40_000]
        snap.append(c)
    chunks = [c.tobytes() for c in snap]
    for _ in range(snapshots - 1):
        nxt = []
        for c in snap:
            c2 = c.copy()
            for s in rng.integers(0, chunk_bytes - 8192, 3):
                c2[s : s + 4096] = rng.integers(0, 256, 4096, dtype=np.uint8)
            nxt.append(c2)
        chunks.extend(c.tobytes() for c in nxt)
        snap = nxt
    return chunks


# ---- FusedCDCFP and DeviceBatchRunner vs the host path ----


def test_fused_matches_host_paths():
    rng = np.random.default_rng(31)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8) for n in (1, 100, 4096, 65536, 100_000, 1 << 17)]
    chunks.append(np.zeros(70_000, np.uint8))
    fused = fused_cdc.FusedCDCFP(PARAMS, device="cpu")
    batch = np.stack([_pad(c, 1 << 17) for c in chunks])
    for c, (ends, fps) in zip(chunks, fused(batch, [len(c) for c in chunks])):
        want_ends, want_fps = cdc_and_fps_host(c, PARAMS)
        j_ends, j_fps = jcdc.cdc_and_fps_host(c, JPARAMS)
        np.testing.assert_array_equal(ends, want_ends)
        np.testing.assert_array_equal(ends, j_ends)
        assert fps == want_fps == j_fps


def test_fused_overflow_row_recomputed_exactly(monkeypatch):
    """Candidate counts above the cap route the row through the exact host
    path; the cap is shrunk on the PORT's module only."""
    params = CDCParams(min_bytes=64, avg_bytes=256, max_bytes=1024)
    monkeypatch.setattr(fused_cdc, "candidate_cap", lambda bucket, params=None: 16)
    called = []
    real = fused_cdc._host_exact
    monkeypatch.setattr(fused_cdc, "_host_exact", lambda arr, p: called.append(1) or real(arr, p))
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    (ends, fps), = fused_cdc.FusedCDCFP(params, device="cpu")(chunk[None, :], [len(chunk)])
    assert called, "overflow did not take the host path"
    j_ends, j_fps = jcdc.cdc_and_fps_host(chunk, jcdc.CDCParams(min_bytes=64, avg_bytes=256, max_bytes=1024))
    np.testing.assert_array_equal(ends, j_ends)
    assert fps == j_fps


def test_all_fallback_batch_releases_pooled_scratch(monkeypatch):
    monkeypatch.setattr(fused_cdc, "candidate_cap", lambda bucket, params=None: 1)
    pool = BufferPool()
    fused = fused_cdc.FusedCDCFP(CDCParams(min_bytes=64, avg_bytes=256, max_bytes=1024), pool=pool, device="cpu")
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (2, 1 << 16), dtype=np.uint8)
    pending = fused.dispatch(batch, [1 << 16, 1 << 16])
    assert all(f is not None for f in pending.fallback)
    for i in range(2):
        pending.result_row(i)
    assert pool.counters()["pool_outstanding"] == 0


def test_batch_runner_concurrent_matches_host():
    rng = np.random.default_rng(17)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8) for n in rng.integers(1000, 150_000, 10)]
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, max_wait_ms=20, device="cpu")
    with ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(runner.cdc_and_fps, chunks))
    for c, (ends, fps) in zip(chunks, results):
        j_ends, j_fps = jcdc.cdc_and_fps_host(c, JPARAMS)
        np.testing.assert_array_equal(ends, j_ends)
        assert fps == j_fps
    c = runner.counters()
    assert c["batch_rows"] == len(chunks) and c["pool_outstanding"] == 0
    assert c["batch_windows"] < len(chunks)  # windows really batched


def test_batch_runner_stress_more_threads_than_cores():
    """24 threads (more than the cores here) with a short switch interval:
    every chunk still gets its own exact result, and every pooled buffer
    comes back."""
    rng = np.random.default_rng(23)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8) for n in rng.integers(1, 70_000, 48)]
    want = [cdc_and_fps_host(c, PARAMS) for c in chunks]
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, max_wait_ms=1, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=24) as pool:
            got = list(pool.map(runner.cdc_and_fps, chunks))
    finally:
        sys.setswitchinterval(old)
    for (ends, fps), (w_ends, w_fps) in zip(got, want):
        np.testing.assert_array_equal(ends, w_ends)
        assert fps == w_fps
    c = runner.counters()
    assert c["batch_rows"] == len(chunks) and c["pool_outstanding"] == 0


# the port's stage timings (docs/observability_torch.md), which the JAX package does not count
PORT_RUNNER_STAGE_KEYS = {"window_wait_ns", "stage_ns", "stage_bytes", "stage_rows"}
PORT_SENDER_STAGE_KEYS = {"admit_wait_ns", "read_ns", "encode_ns", "seal_ns", "forward_wait_ns", "forward_chunks"}


def test_counter_key_schemas_match_reference():
    from skyplane_tpu.ops.batch_runner import DeviceBatchRunner as JDeviceBatchRunner

    runner = DeviceBatchRunner(cdc_params=PARAMS, device="cpu")
    jrunner = JDeviceBatchRunner(cdc_params=JPARAMS)
    assert set(runner.counters()) == set(jrunner.counters()) | PORT_RUNNER_STAGE_KEYS
    for port_runner, ref_runner in ((runner, jrunner), (None, None)):
        port = DataPathProcessor(codec_name="none", cdc_params=PARAMS, batch_runner=port_runner, device="cpu")
        ref = jpipeline.DataPathProcessor(codec_name="none", cdc_params=JPARAMS, batch_runner=ref_runner)
        assert set(port.stats.as_dict()) == set(ref.stats.as_dict()) | PORT_RUNNER_STAGE_KEYS | PORT_SENDER_STAGE_KEYS
        assert port.stats.as_dict()["donated_batches"] == 0


# ---- wire format ----


def test_wire_header_and_codec_ids_match_reference():
    assert {c.name: int(c) for c in Codec} == {c.name: int(c) for c in jpipeline.Codec}
    fields = dict(chunk_id=uuid.uuid4().hex, data_len=123, raw_data_len=456, codec=int(Codec.TPU_BLOCK),
                  flags=int(ChunkFlags.RECIPE), fingerprint="ab" * 16, n_chunks_left_on_socket=7, tenant_id="cd" * 8)
    raw = WireProtocolHeader(**fields).to_bytes()
    assert raw == JWireProtocolHeader(**fields).to_bytes() and len(raw) == 86
    assert WireProtocolHeader.from_bytes(raw) == WireProtocolHeader(**fields)


def test_blockpack_container_matches_reference():
    from skyplane_tpu.ops import blockpack as jblockpack

    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, 100_003, dtype=np.uint8)
    data[:30_000] = 0
    data[40_000:41_024] = 9
    for raw in (b"", data.tobytes(), data[:513].tobytes()):
        enc = blockpack.encode_container(raw)
        assert enc == jblockpack.encode_container(raw)
        assert blockpack.decode_container(enc) == raw == jblockpack.decode_container(enc)


def test_effective_codec_name_keys_on_device(monkeypatch):
    assert effective_codec_name("tpu_zstd", device="cpu") == "zstd"
    assert effective_codec_name("tpu", device="cpu") == "tpu"
    # the opt-out keeps the container codec on the CPU, as the JAX package does
    monkeypatch.setenv("SKYPLANE_TPU_KEEP_TPU_CODEC", "1")
    assert effective_codec_name("tpu_zstd", device="cpu") == "tpu_zstd" == jpipeline.effective_codec_name("tpu_zstd")


# ---- end to end ----


def _process_all(proc, chunks, index):
    out = []
    for c in chunks:
        p = proc.process(c, index)
        for fp, size in p.new_fingerprints:  # delivered -> commit (sender contract)
            index.add(fp, size)
        out.append(p)
    return out


def _header(p, chunk_id, mod):
    return mod(chunk_id=chunk_id, data_len=len(p.wire_bytes), raw_data_len=p.raw_len, codec=int(p.codec),
               flags=int(ChunkFlags.RECIPE) if p.is_recipe else 0, fingerprint=p.fingerprint)


@pytest.mark.parametrize("codec", ["none", "tpu", "native_lz", "lz4"])
def test_process_wire_bytes_match_reference_and_cross_restore(codec):
    if codec == "lz4":
        from skyplane_tpu_torch.utils import lz4ref

        if not lz4ref.available():
            pytest.skip("the system liblz4 (liblz4.so.1) is not present on this host")
    chunks = _mini_corpus()
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, device="cpu")
    port = DataPathProcessor(codec_name=codec, cdc_params=PARAMS, batch_runner=runner, paranoid_verify=True, device="cpu")
    ref = jpipeline.DataPathProcessor(codec_name=codec, cdc_params=JPARAMS, paranoid_verify=True)
    port_out = _process_all(port, chunks, SenderDedupIndex())
    ref_out = _process_all(ref, chunks, jdedup.SenderDedupIndex())
    assert sum(p.n_ref_segments for p in port_out) > 0
    for a, b in zip(port_out, ref_out):
        assert (a.wire_bytes, a.fingerprint, a.codec, a.n_ref_segments) == (b.wire_bytes, b.fingerprint, b.codec, b.n_ref_segments)
    # the port restores the JAX sender's frames; the JAX package restores the port's
    port_store, ref_store = SegmentStore(), jdedup.SegmentStore()
    for c, a, b in zip(chunks, port_out, ref_out):
        cid = uuid.uuid4().hex
        assert port.restore(b.wire_bytes, _header(b, cid, WireProtocolHeader), port_store) == c
        assert ref.restore(a.wire_bytes, _header(a, cid, JWireProtocolHeader), ref_store) == c
    pooled = port.restore(ref_out[-1].wire_bytes, _header(ref_out[-1], uuid.uuid4().hex, WireProtocolHeader), port_store, pooled=True)
    assert bytes(pooled.view) == chunks[-1]
    pooled.release()
    # dedup off (no index): the plain codec frame, raw when incompressible
    for raw in (chunks[0], np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8).tobytes()):
        a, b = port.process(raw), ref.process(raw)
        assert (a.wire_bytes, a.codec, a.fingerprint, a.is_recipe) == (b.wire_bytes, b.codec, b.fingerprint, False)
        assert port.restore(b.wire_bytes, _header(b, uuid.uuid4().hex, WireProtocolHeader)) == raw


@pytest.mark.parametrize("batched", [False, True])
def test_verify_counters_match_reference(batched):
    chunks = _mini_corpus(seed=5)
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, device="cpu") if batched else None
    port = DataPathProcessor(codec_name="tpu", cdc_params=PARAMS, batch_runner=runner, paranoid_verify=True, device="cpu")
    ref = jpipeline.DataPathProcessor(codec_name="tpu", cdc_params=JPARAMS, paranoid_verify=True)
    assert port.verify_counters() == ref.verify_counters() == {"verify_total": 0, "verify_batched": 0}
    sent = _process_all(ref, chunks, jdedup.SenderDedupIndex())
    sent.append(ref.process(chunks[0]))  # a plain frame: no recipe, no paranoid verify
    port_store, ref_store = SegmentStore(), jdedup.SegmentStore()
    for c, b in zip(chunks + [chunks[0]], sent):
        cid = uuid.uuid4().hex
        assert port.restore(b.wire_bytes, _header(b, cid, WireProtocolHeader), port_store) == c
        assert ref.restore(b.wire_bytes, _header(b, cid, JWireProtocolHeader), ref_store) == c
    assert port.verify_counters() == ref.verify_counters() == {"verify_total": len(chunks), "verify_batched": 0}


def test_exact_bucket_chunk_skips_the_pooled_copy(monkeypatch):
    """The unbatched path hands a chunk that is already a whole bucket long to
    FusedCDCFP as it is; results and pool counters equal the JAX package's
    unbatched device path (run here on its CPU backend)."""
    monkeypatch.setattr(jpipeline.DataPathProcessor, "_on_accelerator", staticmethod(lambda: True))
    port = DataPathProcessor(codec_name="none", cdc_params=PARAMS, device="cpu")
    ref = jpipeline.DataPathProcessor(codec_name="none", cdc_params=JPARAMS)
    rng = np.random.default_rng(8)
    for n in (1 << 16, 100_000, 1 << 17):  # a whole bucket, a padded one, a whole bucket again
        arr = np.frombuffer(rng.integers(0, 256, n, dtype=np.uint8).tobytes(), np.uint8)  # read-only, as process() passes it
        ends, fps = port._cdc_and_fps(arr)
        j_ends, j_fps = ref._cdc_and_fps(arr)
        np.testing.assert_array_equal(ends, j_ends)
        assert fps == j_fps
        assert port.bufpool.counters() == ref.bufpool.counters()
    assert port.bufpool.counters()["pool_hits"] == 1  # the 2^17 chunk reused nothing but the ends scratch


def test_index_from_reference_carries_a_warm_destination():
    """A port sender seeded with a JAX sender's committed fingerprints REFs
    what that sender already delivered."""
    chunks = _mini_corpus(seed=4, n_chunks=2)
    ref = jpipeline.DataPathProcessor(codec_name="none", cdc_params=JPARAMS)
    jindex = jdedup.SenderDedupIndex()
    _process_all(ref, chunks[:2], jindex)
    entries = [(fp, size) for s in jindex._stripes for fp, (size, _) in s.lru.items()]
    port = DataPathProcessor(codec_name="none", cdc_params=PARAMS, device="cpu")
    p = port.process(chunks[2], state.index_from_reference(entries))
    want = ref.process(chunks[2], jindex)
    assert p.wire_bytes == want.wire_bytes and p.n_ref_segments > 0


def test_receiver_waits_for_a_racing_literal():
    store = SegmentStore()
    fp, seg = b"\x01" * 16, b"segment"
    t = threading.Timer(0.05, store.put, args=(fp, seg))
    t.start()
    assert store.get(fp, wait_timeout=5.0) == seg
    t.join()
    with pytest.raises(Exception, match="unresolvable"):
        store.get(b"\x02" * 16, wait_timeout=0.01)


def test_entry_points_refuse_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPathProcessor(codec_name="none")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBatchRunner()


# ---- import hygiene ----


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every port module imports, the slices' entry points run, two
    plaintext port daemons (``device="cpu"``) move a file from source to
    destination, and the client, the pipeline, the planner and the local
    provisioner import and plan a job, with neither jax, the JAX package,
    ``requests`` nor ``cryptography`` imported. The cloud backends and
    providers that import an SDK are left out of the walk (boto3, google,
    pyarrow and azure-storage-blob; the GCP and SCP ones bring ``requests``),
    as in the JAX package, and
    ``tests/test_torch_gateway_bootstrap.py::test_cloud_path_imports_no_jax``
    and ``tests/test_torch_multicloud.py::test_multicloud_path_imports_no_jax``
    import them, with the SDK stand-ins, free of jax."""
    code = (
        "import pkgutil, importlib, sys, skyplane_tpu_torch\n"
        "sdk = tuple('skyplane_tpu_torch.' + m for m in ('obj_store.s3_interface', 'obj_store.r2_interface',\n"
        "            'obj_store.gcs_interface', 'obj_store.hdfs_interface', 'obj_store.azure_blob_interface',\n"
        "            'obj_store.cos_interface', 'obj_store.scp_interface', 'compute.aws.', 'compute.gcp.', 'compute.scp.'))\n"
        "for m in pkgutil.walk_packages(skyplane_tpu_torch.__path__, 'skyplane_tpu_torch.'):\n"
        "    if not m.name.startswith(sdk):\n"
        "        importlib.import_module(m.name)\n"
        "from skyplane_tpu_torch.entry import entry\n"
        "from skyplane_tpu_torch.ops.blockpack import decode_device, encode_device\n"
        "from skyplane_tpu_torch.ops.fingerprint import fixed_stride_lanes\n"
        "from skyplane_tpu_torch.ops.kernels import blockpack_encode, gear_mask, segment_fp_fixed\n"
        "from skyplane_tpu_torch.ops.pipeline import datapath_step\n"
        "import numpy as np\n"
        "from skyplane_tpu_torch.native import datapath, lz\n"
        "from skyplane_tpu_torch.utils import lz4ref\n"
        "from skyplane_tpu_torch.ops.host_fallback import boundary_candidates_host, gear_hash_host\n"
        "x = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8)\n"
        "assert datapath.available()\n"
        "assert (datapath.gear_candidates(x, 4) == boundary_candidates_host(gear_hash_host(x), 4)).all()\n"
        "assert lz.decompress(lz.compress(b'abc' * 100)) == b'abc' * 100\n"
        "assert not lz4ref.available() or lz4ref.decompress(lz4ref.compress(b'abc'), 3) == b'abc'\n"
        "assert 'skyplane_tpu_torch.entry' in sys.modules\n"
        "from skyplane_tpu_torch.api.client import SkyplaneClient\n"
        "from skyplane_tpu_torch.api.config import TransferConfig\n"
        "from skyplane_tpu_torch.api.pipeline import Pipeline\n"
        "from skyplane_tpu_torch.api.transfer_job import CopyJob\n"
        "from skyplane_tpu_torch.compute.local import LocalCloudProvider, local_gateway_device\n"
        "from skyplane_tpu_torch.obj_store.posix_file_interface import POSIXInterface\n"
        "from skyplane_tpu_torch.planner.planner import get_planner\n"
        "assert local_gateway_device({}) == 'cuda'\n"
        "import threading, time\n"
        "from pathlib import Path\n"
        "from skyplane_tpu_torch.chunk import Chunk, ChunkRequest\n"
        "from skyplane_tpu_torch.gateway.control_auth import control_session\n"
        "from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon\n"
        "root = Path(sys.argv[1])\n"
        "data = x.tobytes() * 40\n"
        "(root / 'src.bin').write_bytes(data)\n"
        "def start(gid, prog, info):\n"
        "    d = GatewayDaemon('local:local', str(root / gid), {'plan': [{'partitions': ['default'], 'value': [prog]}]}, info,\n"
        "                      gid, control_port=0, bind_host='127.0.0.1', use_tls=False, device='cpu')\n"
        "    threading.Thread(target=d.run, daemon=True).start()\n"
        "    return d\n"
        "dst = start('gw_dst', {'op_type': 'receive', 'dedup': True, 'children': [{'op_type': 'write_local', 'children': []}]}, {})\n"
        "src = start('gw_src', {'op_type': 'read_local', 'num_connections': 1, 'children': [{'op_type': 'send',\n"
        "             'target_gateway_id': 'gw_dst', 'num_connections': 1, 'compress': 'tpu', 'dedup': True, 'children': []}]},\n"
        "             {'gw_dst': {'public_ip': '127.0.0.1', 'control_port': dst.api.port}})\n"
        "req = ChunkRequest(chunk=Chunk(src_key=str(root / 'src.bin'), dest_key=str(root / 'dst.bin'),\n"
        "                   chunk_id='ab' * 16, chunk_length_bytes=len(data), file_offset_bytes=0))\n"
        "sess = control_session()\n"
        "sess.post(f'http://127.0.0.1:{src.api.port}/api/v1/chunk_requests', json=[req.as_dict()], timeout=10).raise_for_status()\n"
        "deadline = time.monotonic() + 30\n"
        "while time.monotonic() < deadline:\n"
        "    st = sess.get(f'http://127.0.0.1:{dst.api.port}/api/v1/chunk_status_log', timeout=10).json()['chunk_status']\n"
        "    if st.get('ab' * 16) == 'complete':\n"
        "        break\n"
        "    time.sleep(0.05)\n"
        "src.stop(); dst.stop()\n"
        "assert (root / 'dst.bin').read_bytes() == data\n"
        "job = CopyJob('local:///', ['local:///'], recursive=True)\n"
        "job._src_iface = POSIXInterface(str(root), region_tag='local:siteA')\n"
        "job._dst_ifaces = [POSIXInterface(str(root / 'out'), region_tag='local:siteB')]\n"
        "plan = get_planner('direct', TransferConfig(compress='tpu', auto_codec_decision=False), quota_limits_file='').plan([job])\n"
        "assert sorted(g.region_tag for g in plan.gateways.values()) == ['local:siteA', 'local:siteB']\n"
        "assert Pipeline(provisioner=SkyplaneClient(log_dir=str(root / 'log')).provisioner).planner() is not None\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'skyplane_tpu', 'requests', 'cryptography'))\n"
        "print(len([n for n in sys.modules if n.startswith('skyplane_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_name_no_jax_import():
    files = sorted((REPO / "skyplane_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "skyplane_tpu"), f"{f.relative_to(REPO)} imports {mod}"
