"""One run of one cell: set-up, the measured window, the drain, the check
of what the timed path produced, and the result line.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``port_bench/configs/<config>.json``, the deployment: fan-out, codec,
dedup, encryption, CDC sizes) and a traffic mix
(``port_bench/mixes/<traffic>.json``: content, object size, schedule,
budget). Every metric the cell reports is read by its own reader,
``port_bench/metrics/<name>.py``. Adding a cell, a mix or a metric adds
files and entries; nothing here changes.

The run writes its files under ``$TMPDIR`` and removes them; the port's
build caches live in ``port_bench/.cache/`` inside the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from pbench import corpus, reckon, stats, trace
from pbench.fleet import Fleet, e2ee_key, loopback_tx_bytes, read_io
from pbench.imports import forbidden_modules
from pbench.recipe_check import FrameTap, count_bad

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"
CONTROLS = ("cdc_avg_half",)
POST_THREADS = 8  # the open loop's senders: enough that a slow POST delays no later one
REFERENCE_THREADS = 4  # NumPy drops the interpreter lock in the reference's large array steps


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Spec:
    """A cell as BENCHMARK.json and its files define it."""

    def __init__(self, workload: str, bench_path: Path, override: dict):
        bench = json.loads(bench_path.read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.cell = cells[workload]
        cfg_entry = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.cfg = _merge(json.loads((ROOT / cfg_entry["file"]).read_text()), override.get("config", {}))
        self.mix = _merge(json.loads((BENCH_DIR / "mixes" / f"{self.cell['traffic']}.json").read_text()),
                          override.get("mix", {}))
        self.chips = self.cell["chips"]

        def applies(m: dict) -> bool:
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]


def _reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a reader reads: the cell, the window's chunks and completions,
    the bytes the window's traffic put on the loopback link, counter
    snapshots around the window, and the window's device trace."""

    def __init__(self, spec: Spec, seconds: float):
        self.spec, self.seconds = spec, seconds
        self.setup_s: float = 0.0
        self.sizes: List[int] = []
        self.due_wall: List[float] = []
        self.done_wall: List[Optional[float]] = []  # landed at the last sink (its file's mtime); None if not correct
        self.done_at_close: List[bool] = []  # complete at every sink when the window closed, and correct
        self.wire_bytes = 0  # bytes sent over loopback from the window's start until its chunks all landed
        self.before: Dict[str, dict] = {}
        self.after: Dict[str, dict] = {}
        self.events: Optional[list] = None  # device events of the traced window
        self.window_us = 0.0

    def delta(self, group: str, key: str) -> float:
        return self.after[group].get(key, 0) - self.before[group].get(key, 0)

    def lags_ms(self) -> List[float]:
        return stats.lags_ms(self.due_wall, self.done_wall)


def _sum_numeric(dicts) -> dict:
    out: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
    return out


def snapshot(fleet) -> Dict[str, dict]:
    senders = fleet.source.senders()
    return {
        "sender": _sum_numeric(op.datapath_counters() for op in senders),
        "wire": _sum_numeric(op.wire_counters() for op in senders),
        "runner": dict(fleet.source.daemon.batch_runner.counters()),
        "decode": _sum_numeric(g.decode_counters() for g in fleet.sinks),
    }


def card_line() -> str:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unreadable: {err!r}"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cuda (the benchmark) or cpu (the benchmark's own tests)")
    p.add_argument("--control", choices=CONTROLS, help="run the control in the program's place: never correct")
    p.add_argument("--override", default="{}", help="JSON merged into the cell's files (tests: tiny sizes)")
    return p.parse_args(argv)


def set_env(work: Path) -> None:
    """Build caches at fixed paths inside the checkout; the program's logs
    and configuration under the run's own directory. Before the port loads."""
    os.environ["SKYPLANE_TPU_NATIVE_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["SKYPLANE_TPU_LOG_DIR"] = str(work / "logs")
    os.environ["SKYPLANE_TPU_CONFIG_ROOT"] = str(work / "config")
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = Spec(args.workload, ROOT / "BENCHMARK.json", json.loads(args.override))
    work = Path(tempfile.mkdtemp(prefix="port_bench."))
    set_env(work)
    try:
        return _run(args, spec, work, t_start)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def drive(fleet, reqs: list, offsets: List[float], t0: float) -> List[float]:
    """The open loop: each chunk request is POSTed to the source at its due
    time by one of a few threads, whatever the earlier POSTs are doing.
    Returns each POST's start (perf_counter) once every POST has answered."""
    started: List[float] = [0.0] * len(reqs)

    def post(k: int) -> None:
        started[k] = time.perf_counter()
        fleet.source.post("chunk_requests", [reqs[k]])

    with ThreadPoolExecutor(max_workers=POST_THREADS, thread_name_prefix="bench-post") as pool:
        futures = []
        for k, off in enumerate(offsets):
            delay = t0 + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(pool.submit(post, k))
        for f in futures:
            f.result()
    return started


def warm_connections(fleet, src: Path, timeout: float) -> None:
    """Empty objects, one a request a few ms apart, so that every sender
    worker opens its connection in set-up, not in the window: an idle worker
    takes the next request, and an empty object runs no kernel."""
    empty = src / "empty.bin"
    empty.touch()
    n = 4 * fleet.cfg["num_connections"]
    ids = [uuid.uuid4().hex for _ in range(n)]
    for i, cid in enumerate(ids):
        fleet.source.post("chunk_requests", [fleet.request(cid, empty, f"empty{i:03d}.bin", 0)])
        time.sleep(0.003)
    st = fleet.wait(ids, timeout)
    if not all(s.get(c) == "complete" for s in st for c in ids):
        raise RuntimeError(f"connection warm-up did not complete: {fleet.errors()[:3]}")
    for i in range(fleet.cfg["sinks"]):
        for j in range(n):
            (fleet.sink_root(i) / f"empty{j:03d}.bin").unlink(missing_ok=True)


def _device(args, spec: Spec):
    import torch

    if args.device == "cpu":
        return torch.device("cpu"), "cpu", "cpu"
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"the cell needs {spec.chips} CUDA device(s); this machine has {n}")
    return torch.device("cuda", 0), torch.cuda.get_device_name(0), "gpu"


def _run(args, spec: Spec, work: Path, t_start: float) -> int:
    cfg, mix, seconds = spec.cfg, spec.mix, args.seconds
    n_window = reckon.window_objects(cfg, mix, seconds)
    planned = reckon.check_budget(cfg, mix, n_window)
    n_base = mix["base_objects"]
    log(f"cell {spec.cell['name']}: {n_base} base and {n_window} window objects of {mix['object_bytes']} bytes, "
        f"{cfg['sinks']} sink(s); reckoned writes {planned} bytes")
    fleet_cfg = cfg
    if args.control == "cdc_avg_half":
        fleet_cfg = _merge(cfg, {"cdc": {"avg_bytes": cfg["cdc"]["avg_bytes"] // 2}})
    # the sinks boot while this process loads torch and makes the objects
    fleet = Fleet(fleet_cfg, work, e2ee_key(args.seed))
    try:
        return _serve(args, spec, work, t_start, fleet, planned, n_base, n_window)
    finally:
        try:
            fleet.stop()
        finally:
            for s in fleet.sinks:
                if s.proc.returncode not in (0, None):
                    log(f"sink {s.index} exited {s.proc.returncode}: {s.log_tail()}")


def _serve(args, spec: Spec, work: Path, t_start: float, fleet: Fleet, planned: int, n_base: int, n_window: int) -> int:
    import torch

    dev, kind, platform = _device(args, spec)
    run = Run(spec, args.seconds)

    def stage(what: str) -> None:
        log(f"set-up {time.perf_counter() - t_start:.3f} s: {what}")

    stage(f"torch {torch.__version__} on {kind}")
    if dev.type == "cuda":
        log(f"card: {card_line()}")
    cfg, mix, seconds = spec.cfg, spec.mix, args.seconds
    base, window = corpus.make_objects(args.seed, mix, n_base, n_window)
    src = work / "src"
    src.mkdir()
    for i, obj in enumerate(base + window):
        obj.tofile(src / f"obj{i:05d}.bin")
    stage("objects made and written")
    rng = np.random.default_rng([args.seed & 0xFFFFFFFF, args.seed >> 32, 7])
    ids = [uuid.UUID(bytes=rng.bytes(16)).hex for _ in range(n_base + n_window)]

    fleet.start_source(dev)
    stage("daemons up")
    sample_n = min(mix["recipe_sample"], n_window)
    sample_idx = sorted(rng.choice(n_window, sample_n, replace=False).tolist())
    tap = FrameTap(fleet.source.senders(), {ids[n_base + i] for i in sample_idx})
    reqs = [fleet.request(ids[i], src / f"obj{i:05d}.bin", f"obj{i:05d}.bin", mix["object_bytes"])
            for i in range(n_base + n_window)]

    # set-up traffic: the base objects through the fleet, one request at a
    # time at the window's mean pace, so that both sides hold the dedup state
    # a steady replication has and the kernels, connections and sender
    # workers the window uses are warm
    for k in range(n_base):
        fleet.source.post("chunk_requests", [reqs[k]])
        time.sleep(min(0.1, seconds / n_window))
    st = fleet.wait(ids[:n_base], mix["drain_s"] * 4)
    if not all(s.get(c) == "complete" for s in st for c in ids[:n_base]):
        raise RuntimeError(f"set-up objects did not complete: {fleet.errors()[:3]}")
    stage("set-up objects through the fleet")
    warm_connections(fleet, src, mix["drain_s"])
    stage(f"sender connections opened: {[len(op._engines) for op in fleet.source.senders()]}")
    for i in range(cfg["sinks"]):
        for j in range(n_base):
            (fleet.sink_root(i) / f"obj{j:05d}.bin").unlink(missing_ok=True)
    if mix["schedule"] == "even":
        offsets = stats.even_schedule(n_window, seconds * mix["offer_share"])
    else:
        offsets = stats.poisson_schedule(rng, n_window, seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.before = snapshot(fleet)
    lo_before = loopback_tx_bytes()
    prof = None
    if args.trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    wall0 = time.time()
    run.setup_s = t0 - t_start
    sent_at = drive(fleet, [reqs[n_base + k] for k in range(n_window)], offsets, t0)
    delay = t0 + seconds - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    run.after = snapshot(fleet)
    win_ids = ids[n_base:]
    at_close = fleet.statuses(win_ids)  # what a client polling the sinks sees at the close
    late = [(ts - t0 - off) * 1e3 for ts, off in zip(sent_at, offsets)]
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
        run.window_us = (time.perf_counter() - t0) * 1e6
        run.events = trace.device_events(prof)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window closed: {n_window} chunks due, generator lateness ms p50 {stats.percentile(late, 50):.3f} "
        f"max {max(late):.3f}")

    statuses = fleet.wait(win_ids, mix["drain_s"])
    # every byte the window's traffic put on the link, the sinks' acks and
    # the benchmark's few queries with it
    run.wire_bytes = loopback_tx_bytes() - lo_before
    errors = fleet.errors()
    wire_after = snapshot(fleet)["wire"]
    sent = wire_after.get("wire_bytes_sent", 0)
    log(f"loopback bytes from the window's start to the last landing {run.wire_bytes}; the source's own count of "
        f"frame bytes sent {sent - run.before['wire'].get('wire_bytes_sent', 0)}, stream resets "
        f"{wire_after.get('stream_resets', 0) - run.before['wire'].get('stream_resets', 0)}")
    own_io = read_io()  # before the sinks exit: some kernels add a reaped child's counts to its parent's
    fleet.stop()  # the program's state is freed before the reference runs
    if errors:
        log(f"daemon errors: {errors[:3]}")

    # what the timed path produced, against what was offered: every chunk
    # at every sink, then the sampled recipes against the reference
    landed_bad = 0
    for k, obj in enumerate(window):
        cid, ok, last = win_ids[k], True, 0.0
        for i in range(cfg["sinks"]):
            path = fleet.sink_root(i) / f"obj{n_base + k:05d}.bin"
            # a chunk lands when the last byte of its file is written: the
            # file's mtime, set by the kernel, whatever the daemon logs
            landed = path.stat().st_mtime_ns / 1e9 if path.exists() else None
            if statuses[i].get(cid) != "complete" or landed is None \
                    or not np.array_equal(np.fromfile(path, np.uint8), obj):
                ok = False
            else:
                last = max(last, landed)
            path.unlink(missing_ok=True)
        landed_bad += not ok
        run.done_at_close.append(ok and all(st.get(cid) == "complete" for st in at_close))
        run.sizes.append(len(obj))
        run.due_wall.append(wall0 + offsets[k])
        run.done_wall.append(last if ok else None)

    from reference import recipe_ref

    with ThreadPoolExecutor(max_workers=REFERENCE_THREADS, thread_name_prefix="bench-ref") as pool:
        recipes = list(pool.map(lambda i: recipe_ref.recipe(window[i], cfg["cdc"]), sample_idx))
    expected = {ids[n_base + i]: r for i, r in zip(sample_idx, recipes)}
    recipe_bad, notes = count_bad(tap.heads, expected, [g.gateway_id for g in fleet.sinks])
    for note in notes:
        log(f"recipe: {note}")
    ios = [own_io] + [sink.io for sink in fleet.sinks]
    total = {k: sum(io.get(k, 0) for io in ios) for k in ("write_bytes", "cancelled_write_bytes", "wchar")}
    log(f"written bytes (/proc/<pid>/io of this process before the sinks stop, and of each sink until it exits): "
        f"write_bytes {total['write_bytes']}, cancelled_write_bytes {total['cancelled_write_bytes']}, wchar "
        f"{total['wchar']}; wchar less the source's data-socket bytes {total['wchar'] - sent} (reckoned {planned})")

    lags = run.lags_ms()
    q = max(1, len(lags) // 4)
    log(f"lag ms over all {len(lags)} due chunks: p50 {stats.percentile(lags, 50)}, p95 {stats.percentile(lags, 95)}; "
        f"p50 by quarter of the schedule (a growing backlog rises): "
        f"{[stats.percentile(lags[i:i + q], 50) for i in range(0, len(lags), q)]}")
    metric_specs = spec.per_layer if args.trace else spec.end_to_end
    metrics = {}
    for m in metric_specs:
        value = _reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found[:10]}")
        return 3
    checks = {"landed_bad": {"value": landed_bad, "limit": 0}, "recipe_bad": {"value": recipe_bad, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": platform, "kind": kind, "count": spec.chips if dev.type == "cuda" else 0,
              "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": n_window, "failed": landed_bad, "metrics": metrics, "device": device}
    if args.trace:
        busy = trace.busy_us(run.events) / 1e6 if run.events is not None else 0.0
        device.update(busy_s=busy, window_s=run.window_us / 1e6)
        if run.events is not None:
            result["breakdown"] = {"device_ops": trace.top(trace.by_name_s(run.events)),
                                   "idle_gaps": trace.top(trace.idle_gaps_s(run.events, run.window_us))}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
