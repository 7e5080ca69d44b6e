"""The system under test, and the contract of every fleet the harness runs.

A configuration file (``port_bench/configs/<name>.json``) names its fleet by
a ``fleet`` key: a path from the repository root to a Python file that
defines ``Fleet``. Without the key the harness runs ``Fleet`` of this
module, the star fleet. What the harness calls on a fleet:

- ``Fleet(cfg, work, key, chips)``: the configuration as run, the run's own
  directory, the deployment's end-to-end key (AES-256) and the cell's
  number of chips. Called before torch is imported, so that daemons in
  processes of their own boot while the harness loads it: a fleet module
  imports no torch at module level. A key of ``cfg`` that the fleet cannot
  run makes it raise an error naming the key.
- ``start_source(device)``: the source daemon, in this process on
  ``device``, once the others answer. Kernels launched in this process are
  the ones the harness's device trace sees.
- ``source.post(route, body)``: a control-API POST to the source, by which
  every chunk request goes in; ``source.senders()``: its sender operators,
  whose frames the recipe check taps, one stream a target gateway.
- ``sinks``: the gateways whose landed files the check reads,
  ``cfg["sinks"]`` of them in the order of ``cfg["sink_regions"]``, each
  with ``root`` (the directory it writes each ``dest_key`` under) and
  ``gateway_id``.
- ``counters()``: counter groups by name, taken before and after the window;
  the metric readers read them through ``run.delta(group, key)``. The star
  fleet's groups are ``sender`` and ``wire`` (summed over the source's
  sender operators), ``runner`` (the source's batch runner) and ``decode``
  (summed over each sink's ``decode_counters()``); another fleet may add
  groups of its own.
- ``request(chunk_id, src, dest_key, n)``: the body of one chunk request.
- ``statuses(ids)``: each sink's state of each chunk; ``wait(ids,
  timeout)``: the same once each is complete or failed at every sink, or
  at the timeout; ``errors()``: every daemon's errors.
- ``stop()``: ends every daemon and waits for each; ``io()``: each of the
  fleet's processes' ``/proc/<pid>/io`` counters, read until it exited;
  ``exits()``: a line for each of them that exited with an error.

The star fleet: one source gateway daemon and one destination daemon per
sink, ``skyplane_tpu_torch`` ``GatewayDaemon``s talking over loopback TCP,
driven through their control APIs. The programs are the ones the port's
planner writes for a ``local`` copy: the source ``read_local`` -> ``send``
(through ``mux_and`` to every sink when there is more than one), each sink
``receive`` -> ``write_local`` under a root of its own.

The source runs in this process on threads, on the card, with the
``DeviceBatchRunner`` it builds: every kernel of the served path runs there,
so one torch.profiler timeline holds them all. Each sink is a process of its
own (``python -m skyplane_tpu_torch.gateway.gateway_daemon``), as each
gateway is a VM of its own in a deployment, so that no two daemons share an
interpreter lock. A sink runs on the CPU: with paranoid verification off
(the daemon's default) its runner would launch nothing, and a second process
on the card would take memory and time from the first. So the star fleet
refuses a configuration that asks for paranoid verification, for checksums
off or for more than one gateway a region (``Fleet.refused``). On the CPU (the
benchmark's own tests) the source is handed a CPU runner, as a CPU daemon
builds none.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

WRITE_HANDLE = "write"
ROOT = Path(__file__).resolve().parents[2]


def _program(root: dict) -> dict:
    return {"plan": [{"partitions": ["default"], "value": [root]}]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Gateway:
    """A control-API client for one daemon."""

    def __init__(self, gateway_id: str, port: int, tls: bool):
        from skyplane_tpu_torch.gateway.control_auth import control_session

        self.gateway_id = gateway_id
        self.session = control_session()
        self.base = f"{'https' if tls else 'http'}://127.0.0.1:{port}/api/v1/"

    def get(self, route: str, timeout: float = 60, **params) -> dict:
        resp = self.session.get(self.base + route, params=params or None, timeout=timeout)
        resp.raise_for_status()
        return resp.json()

    def post(self, route: str, body) -> None:
        self.session.post(self.base + route, json=body, timeout=60).raise_for_status()

    def wait_up(self, timeout: float, alive=lambda: True) -> None:
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.get("status", timeout=5)
                return
            except Exception:  # noqa: BLE001 - the control API is not up yet
                if time.monotonic() > deadline or not alive():
                    raise RuntimeError(f"daemon {self.gateway_id} did not come up")
                time.sleep(0.05)


class SinkProcess(Gateway):
    """A sink daemon in a child process: ``receive`` -> ``write_local``, or,
    given ``sends``, ``receive`` -> ``mux_and`` -> [``write_local``, the
    sends], as the blast planner writes an interior sink (``docs/blast.md``),
    with ``info`` naming each send's target. ``env`` is laid over the
    daemon's environment: it runs on the CPU unless ``env`` sets
    ``SKYPLANE_GATEWAY_DEVICE``."""

    def __init__(self, work: Path, index: int, cfg: dict, key_file, sends: Sequence[dict] = (),
                 info: Optional[dict] = None, env: Optional[Dict[str, str]] = None):
        self.index, self.port = index, _free_port()
        super().__init__(f"gw_sink{index}", self.port, cfg["encrypt_socket_tls"])
        self.root = work / f"sink{index}"
        program = work / f"sink{index}.program.json"
        write = {"op_type": "write_local", "handle": WRITE_HANDLE, "path": str(self.root), "children": []}
        children = [{"op_type": "mux_and", "handle": "mux", "children": [write, *sends]}] if sends else [write]
        program.write_text(json.dumps(_program({"op_type": "receive", "handle": "recv", "decrypt": cfg["encrypt_e2e"],
                                                "dedup": cfg["dedup"], "children": children})))
        cmd = [sys.executable, "-m", "skyplane_tpu_torch.gateway.gateway_daemon", "--region", cfg["sink_regions"][index],
               "--chunk-dir", str(work / "chunks" / self.gateway_id), "--program-file", str(program),
               "--gateway-id", self.gateway_id, "--control-port", str(self.port), "--bind-host", "127.0.0.1"]
        if info:
            info_file = work / f"sink{index}.info.json"
            info_file.write_text(json.dumps(info))
            cmd += ["--info-file", str(info_file)]
        cmd += ["--e2ee-key-file", str(key_file)] if key_file else []
        cmd += [] if cfg["encrypt_socket_tls"] else ["--disable-tls"]
        env = {**os.environ, "SKYPLANE_GATEWAY_DEVICE": "cpu",
               "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p), **(env or {})}
        self.io: Dict[str, int] = {}
        self.log = work / f"sink{index}.log"
        with open(self.log, "wb") as out:
            self.proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT, cwd=work)

    def decode_counters(self) -> dict:
        return self.get("profile/decode")["counters"]

    def stop(self) -> None:
        """Ask the daemon to stop and wait for its exit, reading its
        ``/proc/<pid>/io`` until then (its last writes are the segment
        store's flush, just before it exits); end it if it does not stop."""
        if self.proc.poll() is not None:
            return
        try:
            self.post("shutdown", {})
        except Exception:  # noqa: BLE001 - a sink that cannot answer is ended below
            pass
        deadline = time.monotonic() + 60
        while self.proc.poll() is None and time.monotonic() < deadline:
            self.io = read_io(self.proc.pid) or self.io
            time.sleep(0.02)
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)

    def log_tail(self, n: int = 2000) -> str:
        return self.log.read_bytes()[-n:].decode("utf-8", "replace") if self.log.exists() else ""


class Source(Gateway):
    """The source daemon in this process on a thread."""

    def __init__(self, daemon, thread: threading.Thread):
        super().__init__(daemon.gateway_id, daemon.api.port, daemon.control_tls)
        self.daemon, self.thread = daemon, thread

    def senders(self) -> list:
        return [op for op in self.daemon.operators if type(op).__name__ == "GatewaySenderOperator"]


def send_op(cfg: dict, handle: str, target: Gateway, region: str) -> dict:
    return {"op_type": "send", "handle": handle, "target_gateway_id": target.gateway_id, "region": region,
            "num_connections": cfg["num_connections"], "compress": cfg["codec"], "encrypt": cfg["encrypt_e2e"],
            "dedup": cfg["dedup"], "children": []}


def gateway_info(gateways) -> dict:
    return {g.gateway_id: {"public_ip": "127.0.0.1", "control_port": g.port} for g in gateways}


def _sum_numeric(dicts) -> dict:
    out: Dict[str, float] = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
    return out


class Fleet:
    """The star fleet: ``Fleet(cfg, work_dir, key, chips)`` spawns the sinks;
    ``start_source(device)`` starts the source once they answer; ``stop()``
    ends all of them. A fleet file may subclass it and replace ``spawn``
    (the sink processes), ``source_children`` (the source's operators under
    ``read_local``) and ``refused``."""

    # keys a configuration may state that this fleet cannot run, each at the
    # one value it runs: the star's sinks are CPU processes at the daemon's
    # defaults, and each gateway of the fleet is one daemon
    refused = {"max_instances": 1, "verify_checksums": True, "paranoid_verify": False}

    def __init__(self, cfg: dict, work: Path, key: bytes, chips: int = 1):
        for k, runs in self.refused.items():
            if k in cfg and cfg[k] != runs:
                raise ValueError(f"configuration key {k}={cfg[k]!r}: this fleet runs only {k}={runs!r}")
        self.cfg, self.work, self.chips = cfg, work, chips
        self.key = key if cfg["encrypt_e2e"] else None
        key_file = None
        if self.key:
            key_file = work / "e2ee.key"
            key_file.write_bytes(self.key)
        self.source = None
        self.sinks: List[SinkProcess] = []
        try:
            self.spawn(key_file)
        except BaseException:
            self.stop()
            raise

    def spawn(self, key_file) -> None:
        for i in range(self.cfg["sinks"]):
            self.sinks.append(SinkProcess(self.work, i, self.cfg, key_file))

    def source_children(self) -> List[dict]:
        sends = [send_op(self.cfg, f"send{i}", s, self.cfg["sink_regions"][i]) for i, s in enumerate(self.sinks)]
        return sends if len(sends) == 1 else [{"op_type": "mux_and", "handle": "mux", "children": sends}]

    def start_source(self, device) -> None:
        from skyplane_tpu_torch.gateway.gateway_daemon import GatewayDaemon
        from skyplane_tpu_torch.ops.cdc import CDCParams

        for s in self.sinks:
            s.wait_up(180, alive=lambda s=s: s.proc.poll() is None)
        cfg, cdc = self.cfg, self.cfg["cdc"]
        params = CDCParams(cdc["min_bytes"], cdc["avg_bytes"], cdc["max_bytes"])
        runner = None
        if device.type == "cpu":
            from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner

            runner = DeviceBatchRunner(cdc_params=params, max_batch=cfg["batch_chunks"], device=device,
                                       gateway_id="gw_src")
        program = _program({"op_type": "read_local", "handle": "read", "num_connections": cfg["num_connections"],
                            "children": self.source_children()})
        info = gateway_info(self.sinks)
        daemon = GatewayDaemon(cfg["source_region"], str(self.work / "chunks" / "gw_src"), program, info, "gw_src",
                               control_port=0, bind_host="127.0.0.1", e2ee_key=self.key,
                               use_tls=cfg["encrypt_socket_tls"], cdc_params=params, device=device,
                               batch_runner=runner)
        if daemon.batch_runner is None:
            raise RuntimeError(f"the source daemon on {device} built no batch runner")
        thread = threading.Thread(target=daemon.run, name="daemon-gw_src", daemon=True)
        thread.start()
        self.source = Source(daemon, thread)
        self.source.wait_up(60)

    def request(self, chunk_id: str, src: Path, dest_key: str, n: int) -> dict:
        return {"chunk": {"src_key": str(src), "dest_key": dest_key, "chunk_id": chunk_id, "chunk_length_bytes": n,
                          "file_offset_bytes": 0},
                "src_region": self.cfg["source_region"], "dst_region": self.cfg["sink_regions"][0],
                "src_type": "local", "dst_type": "local"}

    def statuses(self, ids: List[str]) -> List[Dict[str, str]]:
        """Each sink's chunk_id -> state for ``ids``."""
        out = []
        for g in self.sinks:
            status: Dict[str, str] = {}
            for i in range(0, len(ids), 256):  # keep each query string short
                status.update(g.get("chunk_status_log", chunk_ids=",".join(ids[i : i + 256]))["chunk_status"])
            out.append(status)
        return out

    def counters(self) -> Dict[str, dict]:
        senders = self.source.senders()
        return {
            "sender": _sum_numeric(op.datapath_counters() for op in senders),
            "wire": _sum_numeric(op.wire_counters() for op in senders),
            "runner": dict(self.source.daemon.batch_runner.counters()),
            "decode": _sum_numeric(g.decode_counters() for g in self.sinks),
        }

    def errors(self) -> List[str]:
        errs = []
        for g in ([self.source] if self.source else []) + self.sinks:
            errs.extend(f"{g.gateway_id}: {e}" for e in g.get("errors")["errors"])
        return errs

    def wait(self, ids: List[str], timeout: float) -> List[Dict[str, str]]:
        """Poll until every id is complete or failed at every sink, or until
        ``timeout``; the last statuses."""
        deadline = time.monotonic() + timeout
        while True:
            statuses = self.statuses(ids)
            if all(s.get(c) in ("complete", "failed") for s in statuses for c in ids) or time.monotonic() > deadline:
                return statuses
            time.sleep(0.1)

    def stop(self) -> None:
        if self.source is not None:
            self.source.daemon.stop()
            self.source.thread.join(timeout=60)
        for s in self.sinks:
            s.stop()
        if self.source is not None and self.source.thread.is_alive():
            raise RuntimeError("the source daemon did not stop")

    def io(self) -> List[Dict[str, int]]:
        return [s.io for s in self.sinks]

    def exits(self) -> List[str]:
        return [f"sink {s.index} exited {s.proc.returncode}: {s.log_tail()}" for s in self.sinks
                if s.proc.returncode not in (0, None)]


def read_io(pid="self") -> Dict[str, int]:
    """A process's ``/proc/<pid>/io`` counters ({} once it is gone)."""
    try:
        with open(f"/proc/{pid}/io") as f:
            return {k.strip(): int(v) for k, v in (line.split(":") for line in f)}
    except (OSError, ValueError):
        return {}


def loopback_tx_bytes() -> int:
    """Bytes sent over the loopback interface since the machine booted
    (``/proc/net/dev``), every daemon's traffic in one count; 0 when there
    is no ``lo``."""
    try:
        with open("/proc/net/dev") as f:
            for line in f:
                name, _, fields = line.partition(":")
                if name.strip() == "lo":
                    return int(fields.split()[8])
    except (OSError, ValueError, IndexError):
        pass
    return 0


def e2ee_key(seed: int) -> bytes:
    """The deployment's end-to-end key, made from the seed (AES-256)."""
    return hashlib.blake2b(b"port_bench e2ee %d" % seed, digest_size=32).digest()
