"""The port's meshed batch runner, daemon and pump against the JAX package's
behaviour, on the CPU.

Twins of ``tests/unit/test_batch_runner.py``'s mesh axis selection, the
meshed-runner tests of ``tests/unit/test_spmd_datapath.py``,
``tests/integration/test_spmd_gateway.py`` and
``tests/integration/test_pump.py``'s parent mesh runner. The port's meshes
repeat the CPU (``["cpu"] * n``), the counterpart of the JAX package's forced
host devices; where the JAX tests patch ``maybe_default_mesh`` to a mesh of
host devices, these patch it to a mesh of repeated CPUs. Also: the kernel
launcher's device guard, with the library faked, and ``dryrun_multichip`` on
the CPU at a small production chunk.
"""

from __future__ import annotations

import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.cdc import CDCParams, cdc_segment_ends
from skyplane_tpu_torch.ops.fingerprint import segment_fingerprints_host_batch
from skyplane_tpu_torch.parallel import datapath_spmd
from skyplane_tpu_torch.parallel.datapath_spmd import default_mesh
from tests.test_torch_pump_gateway import _duplicate_sink_registrations, _pump_sender, _until, _wait_bytes
from tests.torch_gateway_util import dispatch, make_pair, stop_all, wait_complete

PARAMS = CDCParams(min_bytes=1024, avg_bytes=4096, max_bytes=16384)


def _expected(chunk, params=PARAMS):
    ends = cdc_segment_ends(chunk, params)
    return ends, segment_fingerprints_host_batch(chunk, ends)


def _pad(chunk):
    from skyplane_tpu_torch.ops.bufpool import bucket_size

    out = np.zeros(bucket_size(len(chunk)), np.uint8)
    out[: len(chunk)] = chunk
    return out


def test_mesh_axis_selection_bounds_window_inflation():
    """A mesh larger than the batch window must not inflate the window past
    2x: the runner falls back to data-axis-only sharding, or unsharded, and
    makes the JAX runner's choices on the same mesh shape."""
    from jax.sharding import Mesh as JMesh

    from skyplane_tpu.ops.batch_runner import DeviceBatchRunner as JRunner

    mesh = default_mesh(["cpu"] * 8)
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), axis_names=("data", "seq"))
    # window smaller than the 8-device flat count but >= data axis (2)
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=3, max_wait_ms=5.0, mesh=mesh, device="cpu")
    jrunner = JRunner(cdc_params=PARAMS, max_batch=3, max_wait_ms=5.0, mesh=jmesh)
    assert runner.shard_axes == jrunner.shard_axes == ("data",)
    assert runner.max_batch == jrunner.max_batch == 4  # rounded to the data axis, not to 8
    assert [p.index for p in runner.fused._positions] == [0, 4]  # one position per data row
    chunk = np.random.default_rng(0).integers(0, 256, size=70_000, dtype=np.uint8)
    ends, fps = runner.cdc_and_fps(chunk, _pad(chunk))
    want_ends, want_fps = _expected(chunk)
    np.testing.assert_array_equal(ends, want_ends)
    assert fps == want_fps
    assert runner.counters()["batch_padded_rows"] == 3  # a mesh window always pads
    # window smaller than every axis: mesh is dropped entirely
    runner2 = DeviceBatchRunner(cdc_params=PARAMS, max_batch=1, max_wait_ms=5.0, mesh=mesh, device="cpu")
    jrunner2 = JRunner(cdc_params=PARAMS, max_batch=1, max_wait_ms=5.0, mesh=jmesh)
    assert runner2.mesh is None and jrunner2.mesh is None and runner2.max_batch == jrunner2.max_batch == 1
    assert runner2.counters()["spmd_devices"] == 1


@pytest.mark.parametrize("n_devices,data_parallel", [(2, 1), (4, 2), (8, 2)], ids=["1x2", "2x2", "2x4"])
def test_meshed_runner_bit_identity_across_meshes(n_devices, data_parallel, monkeypatch):
    """Bit-identical to the host kernels on every viable mesh shape, with a
    window that needs batch-dim padding (3 submissions into a 4-row window)
    and a near-duplicate corpus; SKYPLANE_TPU_SPMD_CHECK armed, so a
    diverging shard fails inside the runner."""
    monkeypatch.setenv("SKYPLANE_TPU_SPMD_CHECK", "1")
    mesh = default_mesh(["cpu"] * n_devices, data_parallel=data_parallel)
    assert dict(mesh.shape) == {"data": data_parallel, "seq": n_devices // data_parallel}
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=4, max_wait_ms=50.0, mesh=mesh, device="cpu")
    local = np.random.default_rng(21)
    base = local.integers(0, 256, size=48_000, dtype=np.uint8)  # non-power-of-two -> padded bucket
    near_dup = base.copy()
    near_dup[1000:1100] = local.integers(0, 256, 100, dtype=np.uint8)
    zeros_head = base.copy()
    zeros_head[: len(base) // 3] = 0
    corpus = [base, near_dup, zeros_head]  # 3 rows -> one zero pad row in the 4-row window
    with ThreadPoolExecutor(max_workers=len(corpus)) as pool:
        results = list(pool.map(lambda c: runner.cdc_and_fps(c), corpus))
    for chunk, (ends, fps) in zip(corpus, results):
        want_ends, want_fps = _expected(chunk)
        np.testing.assert_array_equal(ends, want_ends)
        assert fps == want_fps
    base_fps, dup_fps = set(results[0][1]), set(results[1][1])
    assert len(base_fps & dup_fps) > len(base_fps) // 2
    c = runner.counters()
    assert c["spmd_devices"] == n_devices
    assert c["spmd_batches"] >= 1
    assert c["spmd_check_batches"] >= 1, "the structural bit-identity assertion must have run"
    assert c["batch_padded_rows"] >= 1, "3 rows into a 4-row mesh window must pad"


def test_spmd_check_catches_a_diverging_shard(monkeypatch):
    """SKYPLANE_TPU_SPMD_CHECK fails the window when a position's result
    differs from the host recompute, before any result leaves the runner."""
    monkeypatch.setenv("SKYPLANE_TPU_SPMD_CHECK", "1")
    runner = DeviceBatchRunner(cdc_params=PARAMS, max_batch=2, max_wait_ms=5.0, mesh=default_mesh(["cpu"] * 2),
                               device="cpu")
    from skyplane_tpu_torch.ops import fused_cdc

    real = fused_cdc._fp_impl
    monkeypatch.setattr(fused_cdc, "_fp_impl", lambda b, e, t: real(b, e, t) ^ 1)  # a wrong lane everywhere
    chunk = np.random.default_rng(4).integers(0, 256, size=1 << 16, dtype=np.uint8)
    with pytest.raises(AssertionError, match="SPMD mesh batch diverged"):
        runner.cdc_and_fps(chunk, chunk)


def test_meshed_batch_runner_concurrent_submissions():
    """Eight worker threads share the meshed runner: one window through the
    sharded calls, each chunk's results its own."""
    cdc = CDCParams()
    runner = DeviceBatchRunner(cdc_params=cdc, max_batch=8, mesh=default_mesh(["cpu"] * 8), device="cpu")
    local = np.random.default_rng(6)
    chunks = [local.integers(0, 256, size=1 << 16, dtype=np.uint8) for _ in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(lambda c: runner.cdc_and_fps(c, c), chunks))
    for chunk, (ends, fps) in zip(chunks, results):
        want_ends, want_fps = _expected(chunk, cdc)
        np.testing.assert_array_equal(ends, want_ends)
        assert fps == want_fps


def _patch_mesh(monkeypatch, n, data_parallel=None):
    monkeypatch.setattr(
        datapath_spmd, "maybe_default_mesh", lambda device=None: default_mesh(["cpu"] * n, data_parallel=data_parallel)
    )


@pytest.mark.parametrize(
    "corpus",
    [pytest.param("reference", marks=pytest.mark.slow), "one_mib"],
)
def test_transfer_through_meshed_batch_runner(tmp_path, monkeypatch, corpus):
    """A real transfer (dedup recipes, E2EE, framed sockets, acks) through a
    port daemon pair whose runner is sharded over a 2x4 mesh: the
    reference's corpus (slow, as in the JAX suite) and a 1 MiB file."""
    monkeypatch.setenv("SKYPLANE_TPU_SPMD", "on")  # a CPU daemon builds its runner
    monkeypatch.setenv("SKYPLANE_TPU_BATCH_CHUNKS", "8")
    _patch_mesh(monkeypatch, 8)
    rng = np.random.default_rng(17)
    if corpus == "reference":
        block = rng.integers(0, 256, 128 * 1024, dtype=np.uint8).tobytes()
        payload = block * 10 + rng.integers(0, 256, 256 * 1024, dtype=np.uint8).tobytes() + block * 6
    else:
        block = rng.integers(0, 256, 64 * 1024, dtype=np.uint8).tobytes()
        payload = block * 8 + rng.integers(0, 256, 256 * 1024, dtype=np.uint8).tobytes() + block * 4
    src_file = tmp_path / "src.bin"
    src_file.write_bytes(payload)
    dst_file = tmp_path / "out" / "dst.bin"
    dst_file.parent.mkdir(parents=True)
    src, dst = make_pair(tmp_path, compress="zstd", dedup=True, encrypt=True, use_tls=False, num_connections=4)
    try:
        runner = src.daemon.batch_runner
        assert runner is not None, "SKYPLANE_TPU_SPMD=on must build a batch runner"
        assert runner.mesh is not None and dict(runner.mesh.shape) == {"data": 2, "seq": 4}
        ids = dispatch(src, [(src_file, dst_file, len(payload))], chunk_bytes=256 * 1024)
        wait_complete(src, ids, timeout=180)
        wait_complete(dst, ids, timeout=180)
        assert _wait_bytes(dst_file, payload) == payload
        stats = src.get("profile/compression", timeout=5).json()
        assert stats["ref_segments"] > 0, "dedup REFs must flow through the meshed path"
        assert runner.counters()["spmd_batches"] >= 1
    finally:
        stop_all(src, dst)


def test_pump_batch_work_routes_to_parent_mesh_runner(tmp_path, monkeypatch):
    """SKYPLANE_TPU_SPMD=on + 2 pump procs + a 2x2 mesh: the CPU sender
    workers ship their codec batch work to the PARENT's mesh-sharded runner
    over the control channel. The corpus lands byte-identical, the batch rows
    are counted on the parent runner (SPMD_CHECK armed), and a sender worker
    SIGKILLed after a batch RPC was served requeues its work uncounted."""
    monkeypatch.setenv("SKYPLANE_TPU_PUMP_PROCS", "2")
    monkeypatch.setenv("SKYPLANE_TPU_PERSIST_DEDUP", "0")
    monkeypatch.setenv("SKYPLANE_TPU_SPMD", "on")
    monkeypatch.setenv("SKYPLANE_TPU_BATCH_CHUNKS", "4")
    monkeypatch.setenv("SKYPLANE_TPU_SPMD_CHECK", "1")
    _patch_mesh(monkeypatch, 4, data_parallel=2)
    src_file = tmp_path / "src.bin"
    src_file.write_bytes(np.random.default_rng(31).integers(0, 256, 4 << 20, dtype=np.uint8).tobytes())
    dst_file = tmp_path / "out" / "dst.bin"
    dst_file.parent.mkdir(parents=True)
    src, dst = make_pair(tmp_path, compress="none", dedup=True, num_connections=2)
    try:
        runner = src.daemon.batch_runner
        assert runner is not None, "SKYPLANE_TPU_SPMD=on must build the parent device runner"
        assert runner.mesh is not None and dict(runner.mesh.shape) == {"data": 2, "seq": 2}
        ids = dispatch(src, [(src_file, dst_file, src_file.stat().st_size)], chunk_bytes=256 << 10)
        sender = _pump_sender(src)
        _until(lambda: sender._batch_rpcs_served > 0, 180, "a codec batch served by the parent runner")
        os.kill(sender.pool.live_workers()[0].proc.pid, signal.SIGKILL)
        wait_complete(src, ids, timeout=300)
        wait_complete(dst, ids, timeout=300)
        assert _wait_bytes(dst_file, src_file.read_bytes()) == src_file.read_bytes()
        pump_src = src.daemon._pump_counters()
        assert pump_src["batch_rpcs_served"] >= 1
        assert pump_src["worker_deaths"] >= 1 and pump_src["worker_respawns"] >= 1
        c = runner.counters()
        assert c["batch_rows"] >= pump_src["batch_rpcs_served"]
        assert c["spmd_batches"] >= 1 and c["spmd_check_batches"] >= 1
        assert c["spmd_devices"] == 4
        final = src.get("chunk_status_log", timeout=30).json()["chunk_status"]
        assert not any(state == "failed" for state in final.values())
        assert _duplicate_sink_registrations(dst) == 0
    finally:
        stop_all(src, dst)


# ---- the launcher's device guard ----


class _FakeCUDA:
    """The CUDA runtime's current device, as ``torch.cuda.device`` sees it."""

    def __init__(self, current: int):
        self.current = current

    def exchange(self, idx: int) -> int:
        prev, self.current = self.current, idx
        return prev


def _fake_cuda(monkeypatch, kernels, current: int, entry):
    from types import SimpleNamespace

    cuda = _FakeCUDA(current=current)
    monkeypatch.setattr(torch.cuda, "_exchange_device", cuda.exchange)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device", cuda.exchange)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cuda.current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0xABC))
    monkeypatch.setattr(kernels, "_lib", lambda name: SimpleNamespace(**{f"skyt_{name}": entry(cuda)}))
    return cuda


@pytest.mark.parametrize("current", [0, 3], ids=["another_card", "this_card"])
@pytest.mark.parametrize("fails", [False, True], ids=["launch", "error"])
def test_launch_runs_under_the_device_guard(monkeypatch, fails, current):
    """``_launch`` calls the C entry with the batch's device current and puts
    the caller's back afterwards, also when the entry returns an error, and
    passes that device to the entry (the entries set none themselves)."""
    from skyplane_tpu_torch.ops import kernels

    seen = []

    def entry(cuda):
        def call(*args):
            seen.append((cuda.current, args[-2], args[-1]))
            return 700 if fails else 0

        return call

    cuda = _fake_cuda(monkeypatch, kernels, current, entry)
    before = kernels.launch_counts()["gear_mask"]
    dev = torch.device("cuda", 3)
    if fails:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            kernels._launch("gear_mask", dev, 1, 2)
    else:
        kernels._launch("gear_mask", dev, 1, 2)
    assert seen == [(3, 3, 0xABC)]  # called on device 3, told device 3, on its stream
    assert cuda.current == current  # the caller's device is back
    assert kernels.launch_counts()["gear_mask"] == before + (0 if fails else 1)


def test_nested_launch_tallies_all_count(monkeypatch):
    """A launch counts in every enclosing ``launch_tally`` (a meshed FusedCDCFP's
    and its position's), and a halo launch also under ``gear_mask_halo``."""
    from skyplane_tpu_torch.ops import kernels

    _fake_cuda(monkeypatch, kernels, 0, lambda cuda: lambda *a: 0)
    outer, inner = {}, {}
    with kernels.launch_tally(outer):
        kernels._launch("gear_mask", torch.device("cuda", 0))
        with kernels.launch_tally(inner):
            kernels._launch("gear_mask", torch.device("cuda", 1), also=kernels.GEAR_MASK_HALO)
    assert outer == {"gear_mask": 2, "gear_mask_halo": 1}
    assert inner == {"gear_mask": 1, "gear_mask_halo": 1}


def test_dryrun_multichip_on_cpu(capsys):
    """The twin of ``__graft_entry__.dryrun_multichip`` on four CPU positions
    (2x2), its production stage at 1 MiB chunks: the same line of keys."""
    from skyplane_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", prod_chunk=1 << 20)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    got = json.loads(line)
    assert set(got) == {"metric", "n_devices", "mesh", "prod_chunk_mb", "prod_batch", "ref_segments", "bit_identical"}
    assert got["mesh"] == "2x2" and got["prod_batch"] == 8 and got["ref_segments"] > 0 and got["bit_identical"]
    assert out["prod_counters"]["spmd_devices"] == 4 and out["prod_counters"]["spmd_batches"] >= 2
    assert out["devices"] == ["cpu"] * 4


def test_multi_device_path_imports_no_jax():
    """In a fresh process: ``parallel/``, the meshed runner, ``entry`` and the
    scaling tool run a sharded step and a sharded window with neither jax nor
    the JAX package imported."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import skyplane_tpu_torch.parallel, skyplane_tpu_torch.entry, skyplane_tpu_torch.tools.spmd_scaling\n"
        "from skyplane_tpu_torch.parallel import default_mesh, make_spmd_datapath\n"
        "from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner\n"
        "mesh = default_mesh(['cpu'] * 4)\n"
        "x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16384), dtype=np.uint8))\n"
        "out = make_spmd_datapath(mesh, 16384, 2, 512, 4096, 10)(x)\n"
        "assert tuple(out['n_lit'].shape) == (2, 2)\n"
        "runner = DeviceBatchRunner(max_batch=4, mesh=mesh, device='cpu')\n"
        "runner.cdc_and_fps(np.zeros(70000, np.uint8))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'skyplane_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
