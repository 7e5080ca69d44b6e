"""The port's gateway daemon and control API against the JAX package's.

Port daemons move files to port daemons and, in mixed fleets, to and from
JAX-package daemons (dedup, codec ``tpu``, TLS on data and control, E2EE,
an API token): destination files are byte-identical, and a second transfer of
the same file REFs across the two packages. A port relay forwards a JAX
source's sealed frames to a JAX destination. Twins of the JAX package's
integration tests run on port daemons (drain, control auth, job admission,
a warm persistent index across a restart), and a port daemon serves the same
metric families and status keys as a JAX daemon running the same program.
The module entry point runs on the CPU without jax; configurations that wait
for later slices raise. The port's batch runner journals its first window as
``phase.first_compile``, as the JAX runner does.
"""

from __future__ import annotations

import re
import socket
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from skyplane_tpu_torch.gateway.control_auth import control_session
from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon
from tests.torch_gateway_util import (  # noqa: F401
    dispatch, jax_native_build_dir, make_pair, pkg_ns, program, read_local_op, receive_op, send_op,
    start_gateway, stop_all, wait_complete, write_sources,
)

REPO = Path(__file__).resolve().parent.parent
KEY = bytes(range(32))
T_A, T_B = "a1" * 8, "b2" * 8
FIRST_COMPILE = "phase.first_compile"


def _corpus(seed: int, n: int = 200_000):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return [a, a[5_000:150_000] + rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()]


# ---- step 0: the runner journals its first window ----


def _first_compile_edges(pkg: str, sizes):
    root = {"port": "skyplane_tpu_torch", "ref": "skyplane_tpu"}[pkg]
    import importlib

    events = importlib.import_module(f"{root}.obs.events")
    runner_mod = importlib.import_module(f"{root}.ops.batch_runner")
    rec = events.configure_recorder()
    kw = {"device": "cpu"} if pkg == "port" else {}
    runner = runner_mod.DeviceBatchRunner(cdc_params=pkg_ns(pkg).CDCParams(), max_batch=4, **kw)
    rng = np.random.default_rng(3)
    for n in sizes:
        runner.cdc_and_fps(rng.integers(0, 256, n, dtype=np.uint8))
    out = [(e["edge"], e["bucket"], e["rows"]) for e in rec.events_since(0) if e["kind"] == FIRST_COMPILE]
    events.configure_recorder()
    return out


def test_runner_journals_first_compile_like_the_jax_runner():
    """Windows in two buckets: both runners journal one begin and one end,
    around the first window (its bucket and rows), and none for the second
    bucket's first window."""
    sizes = [20_000, 100_000, 20_000]
    got = _first_compile_edges("port", sizes)
    assert got == _first_compile_edges("ref", sizes)
    assert [edge for edge, _, _ in got] == ["start", "end"]


# ---- transfers between port and JAX-package daemons ----


@pytest.mark.parametrize("src_pkg,dst_pkg", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_transfer_between_packages_with_tls_e2ee_and_token(tmp_path, monkeypatch, src_pkg, dst_pkg):
    pytest.importorskip("cryptography")
    monkeypatch.setenv("SKYPLANE_TPU_DECODE_WORKERS", "2")
    datas = _corpus(11)
    files = write_sources(tmp_path, datas)
    cdc = {"min_bytes": 2048, "avg_bytes": 8192, "max_bytes": 32768}
    src, dst = make_pair(
        tmp_path, src_pkg, dst_pkg, compress="tpu", dedup=True, encrypt=True, use_tls=True, key=KEY,
        api_token=uuid.uuid4().hex, src_kw={"cdc_params": pkg_ns(src_pkg).CDCParams(**cdc)},
        dst_kw={"cdc_params": pkg_ns(dst_pkg).CDCParams(**cdc)},
    )
    try:
        assert src.url("status").startswith("https://")
        wait_complete(dst, dispatch(src, files))
        for (_, dest, _), data in zip(files, datas):
            assert dest.read_bytes() == data, f"{src_pkg} -> {dst_pkg}: {dest.name} differs"
        first = dict(src.sender().datapath_counters())
        # the same file again, to a new destination: every segment REFs across the packages
        again = tmp_path / "dst" / "again.bin"
        wait_complete(dst, dispatch(src, [(files[0][0], again, len(datas[0]))]))
        assert again.read_bytes() == datas[0]
        second = src.sender().datapath_counters()
        new_segments = second["segments"] - first["segments"]
        assert new_segments > 0 and second["ref_segments"] - first["ref_segments"] == new_segments
        assert dst.daemon.receiver.decode_counters()["decode_nacks"] == 0
        assert src.sender().wire_counters()["nacks_reaped"] == 0
        assert control_session(None).get(src.url("chunk_status_log"), timeout=5).status_code == 401
    finally:
        stop_all(src, dst)


def test_three_hop_relay_encrypted_through_a_port_relay(tmp_path):
    """JAX source -> port relay (no key: raw forward) -> JAX destination."""
    dst = start_gateway("ref", program(receive_op(decrypt=True)), {}, "gw_dst", tmp_path / "dst_chunks", e2ee_key=KEY)
    relay = start_gateway(
        "port", program(receive_op(children=[send_op("gw_dst", handle="fwd")])),
        {"gw_dst": {"public_ip": "127.0.0.1", "control_port": dst.control_port}},
        "gw_relay", tmp_path / "relay_chunks", e2ee_key=None,
    )
    src = start_gateway(
        "ref", program(read_local_op(send_op("gw_relay", compress="zstd", encrypt=True))),
        {"gw_relay": {"public_ip": "127.0.0.1", "control_port": relay.control_port}},
        "gw_src", tmp_path / "src_chunks", e2ee_key=KEY,
    )
    try:
        payload = np.random.default_rng(31).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes() + bytes(1 << 20)
        fsrc, fdst = tmp_path / "data.bin", tmp_path / "out" / "data.bin"
        fsrc.write_bytes(payload)
        ids = dispatch(src, [(fsrc, fdst, len(payload))], chunk_bytes=512 * 1024)
        wait_complete(dst, ids, timeout=120)
        assert fdst.read_bytes() == payload
        stats = relay.get("profile/compression", timeout=5).json()
        assert stats["chunks"] == 0 or stats["raw_bytes"] == 0  # no data-path work at the relay
        assert relay.daemon.receiver.raw_forward
    finally:
        stop_all(src, relay, dst)


# ---- twins of the JAX package's daemon integration tests ----


def test_drain_route_is_idempotent_and_operator_triggerable(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYPLANE_TPU_DRAIN_DEADLINE_S", "10")
    src, dst = make_pair(tmp_path, num_connections=2)
    try:
        r1 = src.post("drain", json={"reason": "test drain"}, timeout=10)
        assert r1.status_code == 200 and r1.json()["started"] is True
        r2 = src.post("drain", json={"reason": "again"}, timeout=10)
        assert r2.status_code == 200 and r2.json()["started"] is False
        src.thread.join(timeout=20)
        assert not src.thread.is_alive()
    finally:
        stop_all(src, dst)


def test_transfer_passes_while_unauthenticated_calls_rejected(tmp_path):
    pytest.importorskip("cryptography")
    token = uuid.uuid4().hex
    src_file = tmp_path / "src.bin"
    src_file.write_bytes(np.random.default_rng(5).integers(0, 256, 2 << 20, dtype=np.uint8).tobytes())
    dst_file = tmp_path / "out" / "dst.bin"
    src, dst = make_pair(tmp_path, compress="zstd", dedup=True, encrypt=True, use_tls=True, api_token=token,
                         num_connections=4)
    try:
        assert src.url("status").startswith("https://"), "control plane must ride TLS"
        anon = control_session(None)
        assert anon.get(src.url("status"), timeout=5).status_code == 200
        assert anon.post(src.url("chunk_requests"), json=[], timeout=5).status_code == 401
        assert anon.post(src.url("shutdown"), timeout=5).status_code == 401
        assert anon.post(dst.url("servers"), timeout=5).status_code == 401
        assert anon.post(dst.url("upload_id_maps"), json={"k": "v"}, timeout=5).status_code == 401
        assert anon.get(src.url("chunk_status_log"), timeout=5).status_code == 401
        assert anon.get(src.url("errors"), timeout=5).status_code == 401
        assert control_session("not-the-token").post(src.url("shutdown"), timeout=5).status_code == 401
        ids = dispatch(src, [(src_file, dst_file, src_file.stat().st_size)], chunk_bytes=512 * 1024)
        wait_complete(src, ids)
        wait_complete(dst, ids)
        assert dst_file.read_bytes() == src_file.read_bytes()
    finally:
        stop_all(src, dst)


def test_job_admission_and_429_on_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("SKYPLANE_TPU_MAX_JOBS_PER_TENANT", "3")
    src, dst = make_pair(tmp_path, num_connections=1)
    try:
        for i in range(3):
            r = src.post("jobs", json={"job_id": f"job-{i}", "tenant_id": T_A}, timeout=10)
            assert r.status_code == 200, r.text
        assert src.post("jobs", json={"job_id": "job-3", "tenant_id": T_A}, timeout=10).status_code == 429
        assert src.post("jobs", json={"job_id": "job-b", "tenant_id": T_B}, timeout=10).status_code == 200
        assert src.session().delete(src.url("jobs/job-0"), timeout=10).status_code == 200
        assert src.post("jobs", json={"job_id": "job-3", "tenant_id": T_A}, timeout=10).status_code == 200
        snap = src.get("tenants", timeout=10).json()
        assert snap["tenants"][T_A]["jobs_rejected"] == 1
        assert snap["tenants"][T_A]["active_jobs"] == 3
    finally:
        stop_all(src, dst)


def test_persistent_index_warm_across_daemon_restart(tmp_path):
    base = np.random.default_rng(7).integers(0, 256, 2 << 20, dtype=np.uint8).tobytes()
    (tmp_path / "srcfiles").mkdir()
    f1, f2 = tmp_path / "srcfiles" / "run1.bin", tmp_path / "srcfiles" / "run2.bin"
    f1.write_bytes(base)
    f2.write_bytes(base)
    src, dst = make_pair(tmp_path, dedup=True, num_connections=2)
    try:
        ids = dispatch(src, [(f1, tmp_path / "out" / "run1.bin", len(base))], chunk_bytes=1 << 20)
        wait_complete(src, ids, timeout=120)
        wait_complete(dst, ids, timeout=120)
        assert src.daemon._dedup_indexes["gw_dst"].counters()["index_journal_appends"] > 0
    finally:
        stop_all(src, dst)

    src2, dst2 = make_pair(tmp_path, dedup=True, num_connections=2)
    try:
        assert dst2.daemon.receiver.segment_store.counters()["store_spill_adopted"] > 0
        ids2 = dispatch(src2, [(f2, tmp_path / "out" / "run2.bin", len(base))], chunk_bytes=1 << 20)
        wait_complete(src2, ids2, timeout=180)
        wait_complete(dst2, ids2, timeout=180)
        assert (tmp_path / "out" / "run2.bin").read_bytes() == base
        c = src2.daemon._dedup_indexes["gw_dst"].counters()
        assert c["index_recovered_entries"] > 0 and c["index_warm_fingerprint_hits"] > 0
        stats = src2.sender().processor.stats.as_dict()
        assert stats["ref_segments"] > 0 and stats["wire_bytes"] < stats["raw_bytes"]
    finally:
        stop_all(src2, dst2)


# ---- the control surface matches the JAX daemon's ----


def _families(text: str):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def test_metrics_status_and_status_log_keys_equal_the_jax_daemon(tmp_path, monkeypatch):
    import skyplane_tpu.obs.metrics as ref_metrics
    import skyplane_tpu_torch.obs.metrics as port_metrics

    # fresh process-wide registries: families other tests in this process
    # registered there would be counted as this daemon's
    for mod in (port_metrics, ref_metrics):
        monkeypatch.setattr(mod, "_registry", None)
    datas = _corpus(21, 100_000)
    surfaces = {}
    for pkg in ("port", "ref"):
        files = write_sources(tmp_path / pkg, datas)
        src, dst = make_pair(tmp_path / pkg, pkg, pkg, compress="tpu", dedup=True)
        try:
            ids = dispatch(src, files)
            wait_complete(src, ids)
            wait_complete(dst, ids)
            surfaces[pkg] = {
                name: (
                    _families(gw.get("metrics", timeout=10).text),
                    set(gw.get("status", timeout=10).json()),
                    set(gw.get("chunk_status_log", params={"include_log": 1}, timeout=10).json()),
                    set(gw.get("profile/compression", timeout=10).json()),
                    set(gw.get("tenants", timeout=10).json()),
                )
                for name, gw in (("src", src), ("dst", dst))
            }
        finally:
            stop_all(src, dst)
    for side in ("src", "dst"):
        port, ref = surfaces["port"][side], surfaces["ref"][side]
        assert port[0] == ref[0], (side, sorted(port[0] ^ ref[0]))
        assert any(f.startswith("skyplane_pump_") for f in port[0])
        assert port[1:] == ref[1:], side


def test_module_entry_point_runs_without_jax(tmp_path):
    """``python -m skyplane_tpu_torch.gateway.gateway_daemon --disable-tls`` on
    the CPU answers ``/status``, stops on ``POST /api/v1/shutdown``, and never
    imports jax or the JAX package (``-X importtime`` lists every import)."""
    prog = tmp_path / "program.json"
    prog.write_text('{"plan": [{"partitions": ["default"], "value": [{"op_type": "receive", "dedup": true, '
                    '"children": [{"op_type": "write_local", "children": []}]}]}]}')
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in __import__("os").environ.items() if not k.startswith("SKYPLANE_")}
    env.update(SKYPLANE_GATEWAY_DEVICE="cpu", SKYPLANE_TPU_LOG_DIR=str(tmp_path / "logs"), PYTHONPATH=str(REPO))
    err_log = tmp_path / "stderr.log"  # a file, not a pipe: -X importtime writes more than a pipe holds
    with open(err_log, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "skyplane_tpu_torch.gateway.gateway_daemon", "--disable-tls",
             "--bind-host", "127.0.0.1", "--control-port", str(port), "--chunk-dir", str(tmp_path / "chunks"),
             "--program-file", str(prog), "--gateway-id", "gw_sub"],
            cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=err_f,
        )
    try:
        sess, url = control_session(), f"http://127.0.0.1:{port}/api/v1"
        deadline = time.monotonic() + 60
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status = sess.get(f"{url}/status", timeout=1).json()
                break
            except Exception:  # noqa: BLE001 — not up yet
                time.sleep(0.1)
        assert status is not None and status["gateway_id"] == "gw_sub" and status["status"] == "ok", err_log.read_text()[-2000:]
        assert sess.post(f"{url}/shutdown", timeout=5).status_code == 200
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = err_log.read_text()
    assert proc.returncode == 0, err[-2000:]
    imported = {line.split("|")[-1].strip() for line in err.splitlines() if line.startswith("import time:")}
    assert "skyplane_tpu_torch.gateway.gateway_daemon" in imported or "skyplane_tpu_torch.gateway" in imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "skyplane_tpu"))
    assert not bad, bad


# ---- what the daemon refuses ----


def _receive_daemon(tmp_path, prog=None, **kw):
    return GatewayDaemon("local:local", str(tmp_path / "chunks"), prog or program(receive_op()), {}, "gw",
                         control_port=0, bind_host="127.0.0.1", use_tls=False, **kw)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _receive_daemon(tmp_path)


@pytest.mark.parametrize("case", ["spmd_on", "read_object_store", "write_object_store"])
def test_configurations_waiting_for_later_slices_raise(tmp_path, monkeypatch, case):
    prog = None
    if case == "spmd_on":
        monkeypatch.setenv("SKYPLANE_TPU_SPMD", "on")
        err, match = NotImplementedError, "queue 1 item 6"
    else:
        op = {"op_type": case, "bucket_name": "b", "bucket_region": "aws:us-east-1", "children": []}
        prog, err, match = program(op), ValueError, "queue 1 item 7"
    with pytest.raises(err, match=match):
        _receive_daemon(tmp_path, prog, device="cpu")


def test_cpu_daemon_builds_no_runner_and_takes_a_given_one(tmp_path):
    from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

    d = _receive_daemon(tmp_path / "a", device="cpu")
    assert d.batch_runner is None and d.receiver.processor.batch_runner is None
    runner = DeviceBatchRunner(max_batch=4, device="cpu")
    d2 = _receive_daemon(tmp_path / "b", program(receive_op(dedup=True)), device="cpu", batch_runner=runner)
    assert d2.batch_runner is runner
    for daemon in (d, d2):
        t = threading.Thread(target=daemon.run, daemon=True)
        t.start()
        daemon.stop()
        t.join(timeout=10)
