"""The gateway slice's support modules against the JAX package's, on the CPU.

Chunk records, the dedup index and the segment store (spill included), the
fault injector's seeded decisions, and the public names of every copied
module must equal the JAX package's; the standard-library control client
keeps the surface the gateway uses. Tolerance 0 throughout.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import skyplane_tpu.chunk as jchunk
import skyplane_tpu.exceptions as jexc
import skyplane_tpu.faults as jfaults
import skyplane_tpu.ops.dedup as jdedup
import skyplane_tpu_torch.chunk as tchunk
import skyplane_tpu_torch.exceptions as texc
import skyplane_tpu_torch.faults as tfaults
import skyplane_tpu_torch.ops.dedup as tdedup
from skyplane_tpu_torch.gateway.control_auth import ControlRequestError, ControlTimeout, control_session

# ---- chunk records ----


def _chunk_dicts():
    rng = np.random.default_rng(4)
    out = []
    for i in range(6):
        out.append({
            "chunk": {
                "src_key": f"/src/f{i}", "dest_key": f"/dst/f{i}", "chunk_id": rng.bytes(16).hex(),
                "chunk_length_bytes": int(rng.integers(1, 1 << 30)), "partition_id": f"p{i % 2}",
                "mime_type": None if i % 2 else "application/octet-stream",
                "dest_keys": {"aws:us-east-1": f"k{i}"} if i == 3 else None,
                "file_offset_bytes": int(rng.integers(0, 1 << 40)), "part_number": i, "upload_id": None,
                "multi_part": bool(i % 2), "md5_hash": None, "fingerprint": rng.bytes(16).hex(),
                "traced": i == 2, "hop": i, "tenant_id": rng.bytes(8).hex() if i % 3 else None,
            },
            "src_region": "local:a", "dst_region": "local:b", "src_type": "local", "dst_type": "save_local",
            "src_random_size_mb": None, "src_object_store_bucket": None, "dst_object_store_bucket": None,
        })
    return out


def test_chunk_request_dicts_round_trip_to_the_reference():
    for d in _chunk_dicts():
        port, ref = tchunk.ChunkRequest.from_dict(d), jchunk.ChunkRequest.from_dict(d)
        assert port.as_dict() == ref.as_dict() == d
        assert tchunk.ChunkRequest.from_dict(ref.as_dict()).as_dict() == d
        assert port.chunk.as_dict() == ref.chunk.as_dict()
        kw = dict(n_chunks_left_on_socket=3, wire_length=100, raw_wire_length=200, codec=2, is_compressed=True, is_encrypted=True, is_recipe=True)
        assert port.chunk.to_wire_header(**kw).to_bytes() == ref.chunk.to_wire_header(**kw).to_bytes()


@pytest.mark.parametrize("value", ["a" * 32, "A" * 32, "../../etc/passwd", "0" * 31, 7, None, "", "f" * 16, "g" * 16])
def test_id_validation_matches_the_reference(value):
    for fn in ("validate_chunk_id", "validate_tenant_id"):
        outcomes = []
        for mod, exc in ((tchunk, texc.SkyplaneTpuException), (jchunk, jexc.SkyplaneTpuException)):
            try:
                outcomes.append(("ok", getattr(mod, fn)(value)))
            except exc as e:
                outcomes.append(("raised", str(e)))
        assert outcomes[0] == outcomes[1], fn


def test_chunk_states_and_exceptions_match_the_reference():
    assert [(s.name, s.value) for s in tchunk.ChunkState] == [(s.name, s.value) for s in jchunk.ChunkState]
    assert sorted(tchunk.ChunkState) == [tchunk.ChunkState[s.name] for s in sorted(jchunk.ChunkState)]
    port = {n: c for n, c in vars(texc).items() if isinstance(c, type) and issubclass(c, Exception)}
    ref = {n: c for n, c in vars(jexc).items() if isinstance(c, type) and issubclass(c, Exception)}
    assert set(port) == set(ref)
    for name, cls in port.items():
        assert [b.__name__ for b in cls.__mro__] == [b.__name__ for b in ref[name].__mro__], name
        assert getattr(cls, "pretty_print_header", None) == getattr(ref[name], "pretty_print_header", None)


# ---- dedup index and segment store ----


def _index_state(idx):
    return [list(s.lru.items()) for s in idx._stripes], idx._bytes, len(idx), idx.max_bytes, idx.remote_counters()


def test_sender_dedup_index_equals_the_reference_on_one_call_sequence():
    rng = np.random.default_rng(12)
    fps = [rng.bytes(16) for _ in range(120)]
    port, ref = tdedup.SenderDedupIndex(max_bytes=40_000, stripes=8), jdedup.SenderDedupIndex(max_bytes=40_000, stripes=8)
    evicted = {"port": [], "ref": []}
    port._note_evicted = lambda fp, size: evicted["port"].append((fp, size))
    ref._note_evicted = lambda fp, size: evicted["ref"].append((fp, size))
    for step in range(800):
        op = rng.integers(0, 8)
        fp = fps[int(rng.integers(0, len(fps)))]
        if op <= 2:
            size = int(rng.integers(100, 3000))
            port.add(fp, size, tenant="ab" * 8)
            ref.add(fp, size, tenant="ab" * 8)
        elif op <= 4:
            assert (fp in port) == (fp in ref)
        elif op == 5:
            port.discard(fp)
            ref.discard(fp)
        elif op == 6:
            batch = [(fps[int(i)], 500) for i in rng.integers(0, len(fps), 4)]
            assert port.add_remote(batch, origin="gw") == ref.add_remote(batch, origin="gw")
        else:
            bound = int(rng.integers(10_000, 60_000))
            port.set_max_bytes(bound)
            ref.set_max_bytes(bound)
        assert _index_state(port) == _index_state(ref), f"diverged at step {step}"
    assert evicted["port"] == evicted["ref"] and evicted["port"], "no eviction happened: the sequence is too small"


def _store_state(store, spill_dir):
    counters = {k: v for k, v in store.counters().items() if k not in ("store_ref_wait_ns", "store_stripe_contention")}
    mem = [[(fp, e[0]) for fp, e in s.mem.items()] for s in store._stripes]
    files = sorted(p.name for p in spill_dir.iterdir()) if spill_dir is not None else []
    return counters, mem, list(store._spill_order.items()), files, store.mem_segment_count, store.capacity_bytes


@pytest.mark.parametrize("spill", [False, True])
def test_segment_store_equals_the_reference_on_one_call_sequence(tmp_path, spill):
    rng = np.random.default_rng(13 + spill)
    segs = [(rng.bytes(16), rng.bytes(int(rng.integers(50, 400)))) for _ in range(60)]
    dirs = (tmp_path / "port", tmp_path / "ref") if spill else (None, None)
    kw = dict(max_bytes=4_000, spill_max_bytes=9_000, stripes=4)
    port = tdedup.SegmentStore(spill_dir=dirs[0], **kw)
    ref = jdedup.SegmentStore(spill_dir=dirs[1], **kw)
    assert port.fabric is None and ref.fabric is None
    for step in range(600):
        op = rng.integers(0, 10)
        fp, data = segs[int(rng.integers(0, len(segs)))]
        if op <= 3:
            port.put(fp, data)
            ref.put(fp, data)
        elif op <= 5:
            got = []
            for store, exc in ((port, texc.DedupIntegrityException), (ref, jexc.DedupIntegrityException)):
                try:
                    got.append(store.get(fp))
                except exc:
                    got.append(None)
            assert got[0] == got[1] and got[0] in (None, data)
        elif op == 6:
            assert port.peek(fp) == ref.peek(fp)
        elif op == 7:
            assert (fp in port) == (fp in ref)
        elif op == 8:
            bounds = dict(max_bytes=int(rng.integers(1_000, 6_000)), spill_max_bytes=int(rng.integers(2_000, 12_000)))
            port.set_bounds(**bounds)
            ref.set_bounds(**bounds)
        assert _store_state(port, dirs[0]) == _store_state(ref, dirs[1]), f"diverged at step {step}"
    port.flush_to_spill()
    ref.flush_to_spill()
    assert _store_state(port, dirs[0]) == _store_state(ref, dirs[1])
    counters = port.counters()
    assert counters["store_mem_evictions"] > 0 and counters["store_ref_timeouts"] > 0
    if spill:
        assert counters["store_spill_reads"] > 0 and counters["store_spill_evictions"] > 0
        # a persistent store adopts the spilled segments, as the reference's does
        p2 = tdedup.SegmentStore(spill_dir=dirs[0], persistent_spill=True, **kw)
        r2 = jdedup.SegmentStore(spill_dir=dirs[1], persistent_spill=True, **kw)
        assert _store_state(p2, dirs[0]) == _store_state(r2, dirs[1])
        assert p2.counters()["store_spill_adopted"] > 0


# ---- fault injector ----


def test_fault_injector_fires_as_the_reference_does():
    plan = {"seed": 1337, "points": {
        "sender.send": {"p": 0.3}, "receiver.recv": {"p": 1.0, "after": 5, "max_fires": 3},
        "store.spill_write": {"p": 0.5, "max_fires": 10},
    }}
    port = tfaults.FaultInjector(tfaults.FaultPlan.from_dict(plan))
    ref = jfaults.FaultInjector(jfaults.FaultPlan.from_dict(plan))
    rng = np.random.default_rng(0)
    points = list(plan["points"]) + ["unarmed.point"]
    for _ in range(300):
        point = points[int(rng.integers(0, len(points)))]
        assert port.fire(point) == ref.fire(point), point
    assert port.counters() == ref.counters() and port.eval_counts() == ref.eval_counts()
    assert [(p, i) for _, p, i in port.firing_log()] == [(p, i) for _, p, i in ref.firing_log()]
    for point, spec in plan["points"].items():
        assert tfaults.decision_schedule(1337, point, tfaults.FaultSpec.from_dict(spec), 200) == jfaults.decision_schedule(
            1337, point, jfaults.FaultSpec.from_dict(spec), 200
        )
    assert tfaults.FAULTS_ENV == jfaults.FAULTS_ENV


# ---- every copied module keeps the reference's names ----

_COPIED = [
    "exceptions", "chunk", "utils", "utils.logger", "utils.retry", "utils.envcfg", "utils.fsio", "utils.fn", "utils.timer",
    "faults", "faults.injector", "obs", "obs.tracer", "obs.metrics", "obs.events", "obs.lockwitness",
    "obs.critical_path", "obs.timeline", "obs.profiler", "obs.collector", "gateway.gateway_queue",
    "gateway.chunk_store", "gateway.crypto", "gateway.cert", "gateway.control_auth", "ops.dedup",
    "gateway.operators.gateway_receiver", "gateway.operators.sender_wire", "gateway.operators.gateway_operator",
    "planner.pricing", "gateway.gateway_program", "gateway.preempt", "gateway.gateway_daemon_api",
    "gateway.gateway_daemon", "tenancy", "tenancy.scheduler", "tenancy.registry", "tenancy.persistent_index",
    "dedup_fabric", "dedup_fabric.ring", "dedup_fabric.fabric", "dedup_fabric.exchange", "gateway.pump",
]
# names the port adds (its own control client, the scheduler's resource names,
# the daemon's device and SPMD mode, the pump worker's device and runtime
# report, the tracer's stage timer); it leaves none out
_ADDED = {
    "obs.tracer": {"_Timer"},
    "gateway.control_auth": {"ControlRequestError", "ControlResponse", "ControlSession", "ControlTimeout"},
    "gateway.preempt": {"ControlRequestError", "control_session"},
    "gateway.gateway_daemon": {"resolve_device", "spmd_mode"},
    "gateway.operators.gateway_operator": {"ControlRequestError", "RES_CHUNK_SLOTS", "RES_WIRE_BYTES"},
    "gateway.pump": {"PUMP_CHILD_PLATFORM_ENV", "_child_device", "_runtime_report"},
}
_LEFT_OUT = {}


def _names(mod):
    """The module's own names: imported modules are the module's business."""
    return {n for n, v in vars(mod).items() if not n.startswith("__") and not isinstance(v, type(json))}


@pytest.mark.parametrize("name", _COPIED)
def test_copied_module_keeps_the_reference_names(name):
    port = importlib.import_module(f"skyplane_tpu_torch.{name}")
    ref = importlib.import_module(f"skyplane_tpu.{name}")
    pn, rn = _names(port), _names(ref)
    assert pn - rn <= _ADDED.get(name, set()), f"added: {sorted(pn - rn)}"
    assert rn - pn <= _LEFT_OUT.get(name, set()), f"missing: {sorted(rn - pn)}"


# ---- the standard-library control client ----


class _Echo(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _reply(self, code, obj):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path.startswith("/missing"):
            self._reply(404, {"error": "no"})
        else:
            self._reply(200, {"path": self.path, "auth": self.headers.get("Authorization")})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self._reply(200, {"body": json.loads(self.rfile.read(n)), "auth": self.headers.get("Authorization")})


def test_control_session_keeps_the_surface_the_gateway_uses():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        s = control_session("tok")
        r = s.post(f"{base}/api/v1/chunk_requests", json=[{"a": 1}], timeout=5)
        r.raise_for_status()
        assert r.ok and r.status_code == 200 and r.json() == {"body": [{"a": 1}], "auth": "Bearer tok"}
        r = s.get(f"{base}/api/v1/events", params={"since": "3"}, timeout=5)
        assert r.json()["path"] == "/api/v1/events?since=3"
        assert control_session().get(f"{base}/x", timeout=5).json()["auth"] is None
        r = s.get(f"{base}/missing", timeout=5)
        assert r.status_code == 404 and not r.ok and json.loads(r.text) == {"error": "no"}
        with pytest.raises(ControlRequestError, match="404"):
            r.raise_for_status()
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(ControlRequestError):
        control_session().post(f"{base}/api/v1/servers", json={}, timeout=2)


def test_pump_counter_schema_equals_the_reference():
    from skyplane_tpu.gateway import pump as ref_pump
    from skyplane_tpu_torch.gateway import pump as port_pump

    assert port_pump.PUMP_COUNTER_ZERO == ref_pump.PUMP_COUNTER_ZERO
    assert not port_pump.is_pump_sender(object())


class _Raw(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _reply(self, obj):
        data = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self._reply({"body": self.rfile.read(n).hex(), "type": self.headers.get("Content-Type")})

    def do_DELETE(self):
        self._reply({"deleted": self.path, "flavor": self.headers.get("Metadata-Flavor")})

    def do_GET(self):
        time.sleep(1.0)  # past the caller's timeout, which has closed the connection
        self.close_connection = True


def test_control_session_sends_raw_bodies_deletes_and_times_out():
    """The calls the daemon slice adds: a raw body (the fabric's write-through
    push), DELETE (job release), extra headers (the metadata probes), and a
    timeout told apart from other failures (the fabric's peer-fetch counters)."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Raw)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        s = control_session()
        assert s.post(f"{base}/seg", data=b"\x00\xff", timeout=5).json() == {"body": "00ff", "type": "application/octet-stream"}
        r = s.delete(f"{base}/api/v1/jobs/j1", headers={"Metadata-Flavor": "Google"}, timeout=5)
        assert r.json() == {"deleted": "/api/v1/jobs/j1", "flavor": "Google"}
        with pytest.raises(ControlTimeout):
            s.get(f"{base}/slow", timeout=0.2)
    finally:
        server.shutdown()
        server.server_close()
