"""The port's chunk tracing: one span tree per chunk in each process, with
span and parent ids, from the source's POST to the sink's landing; the
stage counters beside the spans; the disabled tracer's cost at every span
site; the device trace's clock and its account of idle time
(``obs/device_trace.py``); ``POST /api/v1/profile/device``."""

from __future__ import annotations

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import skyplane_tpu_torch.obs.tracer as tracer_mod
from skyplane_tpu_torch.gateway.operators.gateway_receiver import DECODE_COUNTER_ZERO
from skyplane_tpu_torch.obs import NOOP_SPAN, configure_tracer, get_tracer
from skyplane_tpu_torch.obs import device_trace
from skyplane_tpu_torch.obs.tracer import Tracer
from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.pipeline import DataPathStats, DataPathProcessor
from torch_gateway_util import dispatch, make_pair, stop_all, wait_complete, write_sources

SOURCE_SPANS = (
    "chunk.admit", "wire.frame", "chunk.read", "datapath.encode", "device.stage", "batch.window_wait",
    "fused.dispatch", "fused.readback", "wire.seal", "wire.send", "wire.ack_lag",
)
SINK_SPANS = ("frame.recv", "decode.queue", "decode", "decode.open", "decode.restore", "store.write", "chunk.write_local")
# counter -> (group, the span whose interval it times)
COUNTED = {
    "admit_wait_ns": ("sender", "chunk.admit"),
    "read_ns": ("sender", "chunk.read"),
    "encode_ns": ("sender", "datapath.encode"),
    "seal_ns": ("sender", "wire.seal"),
    "window_wait_ns": ("runner", "batch.window_wait"),
    "stage_ns": ("runner", "device.stage"),
    "decode_queue_ns": ("decode", "decode.queue"),
    "decode_open_ns": ("decode", "decode.open"),
    "restore_ns": ("decode", "decode.restore"),
    "land_ns": ("decode", "store.write"),
}


@pytest.fixture
def tracer_at():
    """Install a process tracer at a sample rate; the previous one comes back."""
    saved = tracer_mod._tracer

    def install(sample: float) -> Tracer:
        return configure_tracer(sample=sample)

    yield install
    tracer_mod._tracer = saved


def _one_chunk_pair(tmp_path, n_chunks: int = 1, size: int = 300_000):
    """A port source (read_local -> send, a CPU batch runner) and sink
    (receive -> write_local), codec tpu, dedup, end-to-end encryption; sends
    ``n_chunks`` files and waits until they landed."""
    rng = np.random.default_rng(7)
    files = write_sources(tmp_path, [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n_chunks)])
    runner = DeviceBatchRunner(cdc_params=CDCParams(), max_batch=8, device="cpu")
    src, dst = make_pair(tmp_path, compress="tpu", dedup=True, encrypt=True, src_kw={"batch_runner": runner})
    try:
        ids = dispatch(src, files)
        wait_complete(src, ids)
        wait_complete(dst, ids)
        deadline = time.monotonic() + 10
        # the source's last span (the ack lag) lands just after the chunk completes
        while time.monotonic() < deadline and not any(
            s["name"] == "wire.ack_lag" for s in get_tracer().span_records()
        ) and get_tracer().enabled:
            time.sleep(0.02)
        counters = {
            "sender": src.sender().datapath_counters(),
            "runner": runner.counters(),
            "decode": dst.daemon.receiver.decode_counters(),
        }
    finally:
        stop_all(src, dst)
    return ids, counters


def test_one_chunk_yields_its_span_tree_with_ids_and_matching_counters(tmp_path, tracer_at):
    tracer = tracer_at(1.0)
    (cid,), counters = _one_chunk_pair(tmp_path)
    events = [e for e in tracer.export()["traceEvents"] if e.get("ph") in ("X", "b")]
    mine = [e for e in events if e["args"].get("chunk_id") == cid]
    names = {e["name"] for e in mine}
    assert set(SOURCE_SPANS) | set(SINK_SPANS) <= names, sorted(set(SOURCE_SPANS + SINK_SPANS) - names)
    # every id unique in the process, every parent one of the export's spans
    ids = [e["args"]["span_id"] for e in events]
    assert len(ids) == len(set(ids)) and all(isinstance(i, int) and i > 0 for i in ids)
    for e in events:
        assert e["args"]["parent_id"] is None or e["args"]["parent_id"] in set(ids), e
    by_name = {e["name"]: e for e in mine}
    parent = {name: by_name[name]["args"]["parent_id"] for name in by_name}
    sid = {name: by_name[name]["args"]["span_id"] for name in by_name}
    # the tree: handed over across threads (POST -> worker, framer -> pump
    # and reaper, framing thread -> decode worker), nested on one thread
    assert parent["chunk.admit"] is None and parent["frame.recv"] is None
    assert parent["wire.frame"] == sid["chunk.admit"]
    for name in ("chunk.read", "datapath.encode", "wire.seal", "wire.send", "wire.ack_lag"):
        assert parent[name] == sid["wire.frame"], name
    for name in ("device.stage", "batch.window_wait", "fused.dispatch", "fused.readback"):
        assert parent[name] == sid["datapath.encode"], name
    assert parent["decode.queue"] == parent["decode"] == sid["frame.recv"]
    for name in ("decode.open", "decode.restore", "store.write"):
        assert parent[name] == sid["decode"], name
    # each counter is its span's duration: one chunk, one window, one row
    dur_ns = {}
    for r in tracer.span_records():
        if r["chunk_id"] == cid:
            assert r["name"] not in dur_ns or r["name"] not in {span for _, span in COUNTED.values()}, r["name"]
            dur_ns[r["name"]] = r["end_ns"] - r["start_ns"]
    for key, (group, span) in COUNTED.items():
        assert counters[group][key] == dur_ns[span], (key, counters[group][key], dur_ns[span])
    assert counters["runner"]["stage_rows"] == 1 and counters["runner"]["stage_bytes"] >= 300_000


def test_a_nack_requeued_chunk_counts_its_admission_once(tmp_path, tracer_at):
    """A NACKed chunk comes back to the sender's queue as the same request
    and is framed again; its wait since the POST counts once, as one
    chunk.admit span."""
    from skyplane_tpu_torch.faults import FaultPlan, configure_injector

    tracer = tracer_at(1.0)
    configure_injector(FaultPlan.from_dict({"seed": 1, "points": {"receiver.decode_nack": {"p": 1.0, "max_fires": 1}}}))
    try:
        (cid,), counters = _one_chunk_pair(tmp_path)
    finally:
        configure_injector(None)
    assert counters["decode"]["decode_nacks"] == 1
    mine = [r for r in tracer.span_records() if r["chunk_id"] == cid]
    assert sum(r["name"] == "chunk.read" for r in mine) == 2  # framed twice
    (admit,) = [r for r in mine if r["name"] == "chunk.admit"]
    assert counters["sender"]["admit_wait_ns"] == admit["end_ns"] - admit["start_ns"]


def test_admission_counts_once_per_sender_operator():
    """Multicast branches share one request object: each operator counts the
    request's wait once, and a requeue to the same operator adds nothing."""
    from types import SimpleNamespace

    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest
    from skyplane_tpu_torch.gateway.operators.gateway_operator import GatewaySenderOperator

    req = ChunkRequest(chunk=Chunk(src_key="a", dest_key="b", chunk_id="cd" * 16, chunk_length_bytes=1))
    req.admit_ns, req.admit_handles = time.perf_counter_ns() - 5_000_000, set()
    ops = [
        SimpleNamespace(handle=h, processor=SimpleNamespace(stats=DataPathStats()), _local=threading.local())
        for h in ("send_a", "send_b")
    ]
    for _ in range(3):
        for op in ops:
            GatewaySenderOperator._admit(op, [req])
    for op in ops:
        assert op.processor.stats.as_dict()["admit_wait_ns"] >= 5_000_000
        assert op.processor.stats.as_dict()["admit_wait_ns"] < 3 * 5_000_000
    assert req.admit_handles == {"send_a", "send_b"}
    # a request rebuilt from its dict (a pump worker's) was never admitted here
    rebuilt = ChunkRequest.from_dict(req.as_dict())
    GatewaySenderOperator._admit(ops[0], [rebuilt])
    assert rebuilt.admit_handles is None


def test_stage_counters_are_zeros_in_every_schema():
    stats = DataPathStats().as_dict()
    for key in DataPathStats.STAGE_KEYS + ("window_wait_ns", "stage_ns", "stage_bytes", "stage_rows"):
        assert stats[key] == 0, key
    runner = DeviceBatchRunner(cdc_params=CDCParams(), max_batch=2, device="cpu").counters()
    for key in ("window_wait_ns", "stage_ns", "stage_bytes", "stage_rows"):
        assert runner[key] == 0, key
    for key in ("decode_queue_ns", "decode_open_ns", "restore_ns", "land_ns"):
        assert DECODE_COUNTER_ZERO[key] == 0, key


def test_disabled_tracer_entry_points_allocate_nothing():
    t = Tracer(sample=0.0)
    assert t.span("a", parent=3) is t.span("b", trace_id="00" * 16) is NOOP_SPAN
    assert t.record_span("c", 5, 1, parent=3) == 0 and t.current_span_id() == 0
    counts = {"k": 0}

    def add(key, ns):
        counts[key] += ns

    tracer_file = tracer_mod.__file__
    for _ in range(100):
        with t.span("warm", trace_id="00" * 16, parent=1), t.timed("warm.stage", add, "k", trace_id="00" * 16):
            t.current_span_id()
    tracemalloc.start()
    try:
        for i in range(1000):
            with t.span("hot", trace_id="00" * 16, cat="device", parent=i):
                t.current_span_id()
            with t.timed("hot.stage", add, "k", trace_id="00" * 16, cat="sender", force=True):
                pass
            t.record_span("hot.async", i, i, trace_id="00" * 16, cat="device", parent=i)
        snapshot = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    hits = [s for s in snapshot.statistics("filename") if s.traceback[0].filename == tracer_file and s.count >= 10]
    assert not hits, f"disabled tracer allocates per call: {hits}"
    assert t.counters()["spans_recorded"] == 0
    assert counts["k"] > 0  # the stage counter runs with tracing off


def test_timed_stage_counts_its_span_and_counts_alone_when_untraced():
    counts = {"k": 0}

    def add(key, ns):
        counts[key] += ns

    traced = Tracer(sample=1.0)
    with traced.timed("outer", add, "k", trace_id="ab" * 16, cat="sender") as outer:
        with traced.span("inner", cat="device"):
            time.sleep(0.002)
    recs = {r["name"]: r for r in traced.span_records()}
    assert counts["k"] == recs["outer"]["end_ns"] - recs["outer"]["start_ns"] >= 2_000_000
    assert recs["inner"]["parent_id"] == outer.span_id and recs["inner"]["chunk_id"] == "ab" * 16
    # a chunk the local rate does not sample: only the counter
    counts["k"] = 0
    sparse = Tracer(sample=1e-9)
    cid = next(f"{i:032x}" for i in range(100) if not sparse.sampled(f"{i:032x}"))
    with sparse.timed("stage", add, "k", trace_id=cid, cat="sender"):
        time.sleep(0.001)
    assert counts["k"] >= 1_000_000 and sparse.counters()["spans_recorded"] == 0
    with sparse.timed("stage", add, "k", trace_id=cid, cat="sender", force=True):
        pass
    assert sparse.counters()["spans_recorded"] == 1


class _SpyTracer(Tracer):
    """A tracer that records each call its sites make (keeping every args
    object alive, so that two dicts built by two calls never share an id)."""

    def __init__(self, sample: float):
        super().__init__(sample=sample)
        self.calls = []

    def span(self, name, trace_id=None, cat="", args=None, force=False, parent=None):
        self.calls.append((name, args))
        return super().span(name, trace_id, cat, args, force, parent)

    def record_span(self, name, dur_ns, t0_wall_ns, trace_id=None, cat="", args=None, force=False, parent=None):
        self.calls.append((name, args))
        return super().record_span(name, dur_ns, t0_wall_ns, trace_id, cat, args, force, parent)


def test_disabled_tracer_costs_no_allocation_at_any_span_site(tmp_path):
    """Chunks through every span site with the tracer off: a site either
    skips the tracer or gets the shared no-op, and builds no args per call;
    the same drive with the tracer on reaches every site."""
    saved = tracer_mod._tracer
    try:
        for sample in (1.0, 0.0):
            spy = tracer_mod._tracer = _SpyTracer(sample)
            _one_chunk_pair(tmp_path / f"s{sample}", n_chunks=3, size=200_000)
            if sample:
                reached = {name for name, _ in spy.calls}
                assert set(SOURCE_SPANS) | set(SINK_SPANS) <= reached, sorted(set(SOURCE_SPANS + SINK_SPANS) - reached)
            else:
                built = {}
                for name, args in spy.calls:
                    if args is not None:
                        built.setdefault(name, set()).add(id(args))
                assert all(len(v) <= 1 for v in built.values()), {k: len(v) for k, v in built.items()}
                assert spy.counters()["spans_recorded"] == 0
    finally:
        tracer_mod._tracer = saved


def test_device_wait_is_a_workers_block_on_a_batch_another_worker_runs(tracer_at):
    """Two workers share one window: the leader runs it inside submit (its
    window wait and dispatch are spans of its own, not device wait); the
    other blocks in ends() and records batch.device_wait, async."""
    tracer = tracer_at(1.0)
    runner = DeviceBatchRunner(cdc_params=CDCParams(), max_batch=8, max_wait_ms=200.0, device="cpu")
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 256, 100_000, dtype=np.uint8) for _ in range(2)]
    out = {}

    def work(i):
        with tracer.span("work", trace_id=f"{i:032x}", cat="sender"):
            h = runner.submit(rows[i])
            h.ends(), h.fps()
            out[i] = h.wait_ns

    leader = threading.Thread(target=work, args=(0,))
    leader.start()
    time.sleep(0.05)  # the leader's window is open
    work(1)
    leader.join(timeout=60)
    assert not leader.is_alive()
    assert out[0] == 0 and out[1] > 0
    recs = tracer.span_records()
    waits = [r for r in recs if r["name"] == "batch.device_wait"]
    assert waits and all(w["async"] and w["chunk_id"] == f"{1:032x}" for w in waits)
    assert sum(w["end_ns"] - w["start_ns"] for w in waits) == out[1]
    (window,) = [r for r in recs if r["name"] == "batch.window_wait"]
    assert window["chunk_id"] == f"{0:032x}"
    assert runner.counters()["window_wait_ns"] >= window["end_ns"] - window["start_ns"] - 2_000_000


def test_record_function_anchor_within_a_millisecond_of_a_spans_start(tracer_at):
    """The profiler's events and the spans share the epoch clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = tracer_at(1.0)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with tracer.span("anchor.span", cat="device"):
            with record_function("anchor"):
                torch.zeros(4).sum()
    finally:
        prof.stop()
    start = prof.profiler.kineto_results.trace_start_ns()
    (anchor,) = [e for e in prof.events() if e.name == "anchor"]
    (span,) = [r for r in tracer.span_records() if r["name"] == "anchor.span"]
    assert abs(start + anchor.time_range.start * 1000 - span["start_ns"]) < 1_000_000


MS = 1_000_000


def _span(name, start, end, span_id, parent_id=0, chunk="c1"):
    return {"name": name, "start_ns": start * MS, "end_ns": end * MS, "span_id": span_id, "parent_id": parent_id,
            "chunk_id": chunk, "cat": "sender"}


def test_idle_by_host_keys_gaps_inside_between_and_outside_spans():
    ops = [["gear_compact_kernel", 10 * MS, 20 * MS], ["Memcpy HtoD", 50 * MS, 55 * MS], ["k", 52 * MS, 60 * MS]]
    spans = [
        _span("chunk.admit", 0, 15, 1),
        _span("wire.frame", 25, 40, 2, 1),
        _span("batch.window_wait", 30, 35, 3, 2),
        _span("wire.ack_lag", 42, 45, 4, 2),
        _span("chunk.admit", 70, 80, 5, chunk="c2"),  # a second chunk, after the device ran
    ]
    got = device_trace.idle_by_host(ops, spans, 0, 100 * MS)
    want = {
        "chunk.admit": 0.010 + 0.010,  # [0,10) before the first op; [70,80)
        "wire.frame": 0.010,  # [25,30) and [35,40): the window wait inside it is deeper
        "batch.window_wait": 0.005,
        device_trace.BETWEEN_SPANS: 0.005 + 0.002,  # [20,25), [40,42): c1 in the source, no span open
        "wire.ack_lag": 0.003,
        device_trace.NO_CHUNK: 0.005 + 0.010 + 0.020,  # [45,50), [60,70), [80,100)
    }
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(0.1 - 0.010 - 0.010)
    # no spans at all: the whole idle time is no chunk's
    assert device_trace.idle_by_host(ops, [], 0, 100 * MS) == {device_trace.NO_CHUNK: pytest.approx(0.080)}
    # operations outside the window are clipped away
    assert device_trace.idle_by_host([["k", -5 * MS, 5 * MS]], [], 0, 10 * MS) == {device_trace.NO_CHUNK: pytest.approx(0.005)}


def test_device_route_profiles_and_answers_409_while_a_profiler_runs(tmp_path, tracer_at):
    from torch.profiler import ProfilerActivity, profile

    tracer_at(1.0)
    src, dst = make_pair(tmp_path, src_kw={"batch_runner": DeviceBatchRunner(max_batch=2, device="cpu")})
    try:
        resp = src.post("profile/device", json={"seconds": 0.2}, timeout=30)
        assert resp.status_code == 200
        body = resp.json()
        assert body["device"] == "cpu" and body["ops"] == [] and body["busy_s"] == 0
        t0, t1 = body["window_ns"]
        assert 0.2 <= (t1 - t0) / 1e9 < 5 and body["idle_by_host"]
        assert sum(body["idle_by_host"].values()) == pytest.approx(body["window_s"])
        assert src.post("profile/device", json={"seconds": 0}, timeout=30).status_code == 400
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            busy = src.post("profile/device", json={"seconds": 0.1}, timeout=30)
        finally:
            prof.stop()
        assert busy.status_code == 409
        assert src.post("profile/device", json={"seconds": 0.1}, timeout=30).status_code == 200
    finally:
        stop_all(src, dst)


def test_device_route_loads_nothing_at_daemon_start():
    """setup_s gains no import: the daemon's modules leave obs/device_trace.py
    unloaded until the route is called."""
    import subprocess
    import sys

    code = "import sys, skyplane_tpu_torch.gateway.gateway_daemon; print('skyplane_tpu_torch.obs.device_trace' in sys.modules)"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "False"


def test_processor_without_a_runner_counts_no_stage(tmp_path):
    """The unbatched path stages no row at submit: the runner's stage keys
    stay at their zeros in the processor's schema."""
    proc = DataPathProcessor(codec_name="none", dedup=True, device="cpu")
    from skyplane_tpu_torch.ops.dedup import SenderDedupIndex

    proc.process(np.random.default_rng(1).integers(0, 256, 70_000, dtype=np.uint8).tobytes(), SenderDedupIndex())
    stats = proc.stats.as_dict()
    assert stats["chunks"] == 1 and stats["stage_rows"] == 0 and stats["window_wait_ns"] == 0


@pytest.mark.parametrize("requeue", [False, True], ids=["plain", "injected_requeue"])
def test_relay_forward_counts_once_per_peer_serve_sender_and_equals_its_spans(tmp_path, tracer_at, requeue):
    """src -> relay -> two leaves on CPU daemons (the blast programs): the
    relay's senders count each chunk's wait since its receive operator handed
    it on (``forward_wait_ns``) once per operator (``forward_chunks``), an
    injected peer-serve requeue adds nothing, and the counter is the sum of
    the relay's ``relay.forward`` spans."""
    from skyplane_tpu_torch.blast import solve_blast_tree
    from skyplane_tpu_torch.faults import FaultPlan, configure_injector
    from torch_gateway_util import start_blast_fleet

    tracer = tracer_at(1.0)
    tree = solve_blast_tree("src", {"a": "local:local", "b": "local:local", "c": "local:local"}, "local:local",
                            cost_fn=lambda x, y: 0.0, fanout=2, source_degree=1)
    (relay_id,) = tree.interior_nodes()
    rng = np.random.default_rng(11)
    files = write_sources(tmp_path, [rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes() for _ in range(3)])
    inj = configure_injector(FaultPlan.from_dict({"seed": 1, "points": {"relay.peer_serve": {"p": 1.0, "max_fires": 2}}})
                             if requeue else None)
    source, sinks, _ = start_blast_fleet(tmp_path, tree)
    try:
        ids = dispatch(source, files)
        for gw in sinks.values():
            wait_complete(gw, ids)
        senders = [op for op in sinks[relay_id].daemon.operators if type(op).__name__ == "GatewaySenderOperator"]
        counters = [op.datapath_counters() for op in senders]
        fired = inj.counters().get("relay.peer_serve", 0)
    finally:
        configure_injector(None)
        stop_all(source, *sinks.values())
    assert len(senders) == 2 and all(op.peer_serve for op in senders) and fired == (2 if requeue else 0)
    assert [c["forward_chunks"] for c in counters] == [len(ids)] * 2
    spans = [r for r in tracer.span_records() if r["name"] == "relay.forward"]
    assert len(spans) == 2 * len(ids) and {r["chunk_id"] for r in spans} == set(ids)
    assert sum(c["forward_wait_ns"] for c in counters) == sum(r["end_ns"] - r["start_ns"] for r in spans) > 0
    # a source's chunks come from its POST, never from a receive operator
    assert source.sender().datapath_counters()["forward_chunks"] == 0
