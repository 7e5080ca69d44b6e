"""Gateway control-plane HTTP API.

Reference parity: skyplane/gateway/gateway_daemon_api.py:20-354 (Flask behind
stunnel). Implemented on stdlib ThreadingHTTPServer — gateway VMs need no web
framework. Route surface is kept 1:1 so the client tracker logic maps
directly:

  GET  /api/v1/status                      liveness + region
  POST /api/v1/shutdown                    graceful stop
  POST /api/v1/servers                     new receiver data port -> {server_port}
  DELETE /api/v1/servers/<port>            stop a receiver port
  POST /api/v1/chunk_requests              register chunk batch (json list)
  POST /api/v1/requeue_chunks              re-drive already-registered chunks
                                           (json list of ids; registration
                                           map untouched — blast healing)
  GET  /api/v1/chunk_requests              all chunk requests + states
  GET  /api/v1/incomplete_chunk_requests   pending only
  GET  /api/v1/chunk_status_log            aggregate chunk_id -> state map
                                           (?include_log=1 adds the full
                                           transition log)
  POST /api/v1/upload_id_maps              dest_key -> multipart upload id
  POST /api/v1/drain                       graceful drain {reason?, deadline_s?}
                                           (admission stops; in-flight flushes)
  POST /api/v1/retarget                    applied replan: repoint senders at
                                           {new_target_gateway_id, host,
                                           control_port, old_target_gateway_id?}
  POST /api/v1/jobs                        admit a job {job_id, tenant_id,
                                           weight?, quotas?} -> 200 | 429
  POST /api/v1/jobs/<job_id>/heartbeat     refresh a live job's TTL clock
                                           (service mode) -> 200 | 404
  DELETE /api/v1/jobs/<job_id>             release a job's admission slot
  GET  /api/v1/tenants                     tenant/job registry snapshot +
                                           scheduler usage (multitenancy)
  GET  /api/v1/errors                      operator tracebacks
  GET  /api/v1/profile/socket/receiver     per-recv socket profile events
  GET  /api/v1/profile/socket/sender       per-send-window events + wire counters
  GET  /api/v1/profile/compression         GPU data-path stats (ratio, dedup)
  GET  /api/v1/profile/decode              receiver decode-pool counters+events
  GET  /api/v1/profile/cpu                 per-thread CPU seconds (bottleneck
                                           attribution input)
  GET  /api/v1/profile/stacks              sampling-profiler export: folded
                                           stacks + speedscope JSON + the
                                           core-budget summary
                                           (SKYPLANE_TPU_PROFILE_HZ > 0;
                                           ?summary=1 for the summary alone)
  GET  /api/v1/profile/locks               per-lock hold/contention ns + the
                                           observed lock-order graph
                                           (SKYPLANE_TPU_LOCKCHECK=1)
  GET  /api/v1/trace                       Chrome trace-event JSON (Perfetto)
  GET  /api/v1/metrics                     Prometheus text exposition
  GET  /api/v1/events?since=<seq>          flight-recorder tail (bounded,
                                           seq-ordered fleet events)
  GET  /api/v1/telemetry?since=<seq>&cpu=1&profile=1
                                           combined collector scrape: metrics
                                           + trace + events (+ cpu + profile
                                           summary) in ONE round trip
  GET  /api/v1/segment/<fp>                dedup-fabric peer fetch: serve one
                                           segment by fingerprint (binary;
                                           404 = not resident)
  POST /api/v1/segment/<fp>                write-through push landing (raw
                                           body, fingerprint-verified)
  GET  /api/v1/fabric/summary              gossip pull: recently-proved fps +
                                           membership + fabric counters
  POST /api/v1/fabric/summary              gossip push: absorb a peer summary
  POST /api/v1/fabric/membership           replace fleet membership document

Completion accounting (the reference's most bug-prone logic, SURVEY §7 #6):
an explicit per-chunk refcount of terminal-operator completions — a chunk is
complete when every terminal handle of its partition has reported complete;
its staged file is then deleted (reference: gateway_daemon_api.py:89-155).
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Set

from skyplane_tpu_torch.chunk import ChunkRequest, ChunkState, validate_tenant_id
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.gateway.chunk_store import ChunkStore
from skyplane_tpu_torch.gateway.operators.gateway_receiver import GatewayReceiver
from skyplane_tpu_torch.utils.logger import logger


def _parse_fp(hexfp: str) -> Optional[bytes]:
    """16-byte fingerprint from its hex route segment; None when malformed."""
    try:
        fp = bytes.fromhex(hexfp)
    except ValueError:
        return None
    return fp if len(fp) == 16 else None


class GatewayDaemonAPI:
    def __init__(
        self,
        chunk_store: ChunkStore,
        receiver: GatewayReceiver,
        error_event: threading.Event,
        error_queue: "queue.Queue[str]",
        terminal_operators: Dict[str, List[str]],  # partition -> [terminal group names]
        handle_to_group: Optional[Dict[str, Dict[str, str]]] = None,  # partition -> handle -> group
        *,
        region: str,
        gateway_id: str,
        host: str = "0.0.0.0",
        port: int = 8081,
        compression_stats_fn=None,
        sender_profile_fn=None,
        metrics_fn=None,
        trace_fn=None,
        api_token: Optional[str] = None,
        ssl_ctx=None,
        tenant_registry=None,
        tenant_policy_fn=None,
        require_admission: bool = False,
        draining_event: Optional[threading.Event] = None,
        drain_fn=None,
        retarget_fn=None,
        profile_summary_fn=None,
        pump_cpu_fn=None,
        fabric=None,
    ):
        self.chunk_store = chunk_store
        self.receiver = receiver
        self.error_event = error_event
        self.error_queue = error_queue
        self.terminal_operators = terminal_operators
        self.handle_to_group = handle_to_group or {}
        self.region = region
        self.gateway_id = gateway_id
        self.compression_stats_fn = compression_stats_fn or (lambda: {})
        self.sender_profile_fn = sender_profile_fn or (lambda: {"events": [], "counters": {}})
        # observability surface (obs/, docs/observability.md):
        # default to the process-wide tracer/registry so an API constructed
        # bare (tests, harness) still serves both routes
        from skyplane_tpu_torch.obs import get_registry, get_tracer

        self.metrics_fn = metrics_fn or (lambda: get_registry().render_prometheus())
        self.trace_fn = trace_fn or (lambda: get_tracer().export())
        # bearer token required on every route except GET /status (liveness
        # probes predate token distribution during provisioning). None =
        # auth disabled (local in-process harness).
        self.api_token = api_token
        # multi-tenant admission + accounting (docs/multitenancy.md); None
        # keeps the API single-tenant (bare test constructions)
        self.tenant_registry = tenant_registry
        self.tenant_policy_fn = tenant_policy_fn
        self.require_admission = require_admission
        # graceful drain + applied replans (docs/provisioning.md):
        # draining_event set => POST /chunk_requests 503s (admission stopped);
        # drain_fn starts a drain (POST /drain); retarget_fn repoints sender
        # operators at a new next hop (POST /retarget). All optional — bare
        # test constructions keep the old single-purpose surface.
        self.draining_event = draining_event
        self.drain_fn = drain_fn
        self.retarget_fn = retarget_fn
        # multi-process pump telemetry mux (gateway/pump.py): the daemon
        # injects a summary fn that folds pump-worker profiles into the
        # parent's (so flame/monitor see one gateway row whose cores SUM),
        # and a per-worker CPU fn merged into the /profile/cpu payloads.
        # None keeps the bare single-process surface.
        from skyplane_tpu_torch.obs import get_profiler

        self.profile_summary_fn = profile_summary_fn or (lambda: get_profiler().summary())
        self.pump_cpu_fn = pump_cpu_fn
        # fleet dedup fabric (dedup_fabric/, docs/dedup-fabric.md):
        # serves GET/POST /api/v1/segment/<fp> (peer fetch + write-through
        # landing) and the /api/v1/fabric/* membership + gossip routes. None
        # keeps the bare single-gateway surface (all fabric routes 404/503).
        self.fabric = fabric

        self._lock = threading.Lock()
        self._dedup_sources: set = set()  # distinct source gateway ids seen on /servers
        self.chunk_requests: Dict[str, dict] = {}  # chunk_id -> chunk request dict
        self.chunk_status: Dict[str, str] = {}  # chunk_id -> latest aggregate state
        # full transition log, BOUNDED: it grows O(chunks x operators) and a
        # long-lived multi-tenant daemon must not hold it forever — the tail
        # keeps the freshest MAX_STATUS_LOG records, drops are counted and
        # surfaced on ?include_log=1 (truncation is never silent)
        self.chunk_status_log: List[dict] = []
        self._status_log_dropped = 0
        self._terminal_done: Dict[str, Set[str]] = {}  # chunk_id -> completed terminal handles
        # chunks currently being re-driven through the program (blast
        # healing, POST /requeue_chunks): their terminal refcount was reset
        # so GC waits for EVERY branch of the re-pass; a second requeue of
        # the same id is refused until this pass lands (double-enqueueing
        # would race one copy's GC against the other copy's file reads)
        self._redriving: Set[str] = set()
        self._errors: List[str] = []
        self.shutdown_requested = threading.Event()

        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet; goes to fs log
                logger.fs.debug(f"[api] {fmt % args}")

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str, content_type: str) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_bytes(self, code: int, body: bytes) -> None:
                # binary route (segment serving): no JSON round trip
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                return json.loads(raw or b"{}")

            def _authorized(self, method: str) -> bool:
                if api.api_token is None:
                    return True
                path, _ = GatewayDaemonAPI._split_route(self)
                if method == "GET" and path == "/api/v1/status":
                    return True  # open liveness probe (leaks region/id only)
                from skyplane_tpu_torch.gateway.control_auth import token_matches

                if token_matches(self.headers.get("Authorization"), api.api_token):
                    return True
                # drain the body so HTTP/1.1 keep-alive framing stays intact
                length = int(self.headers.get("Content-Length", 0) or 0)
                if length:
                    self.rfile.read(length)
                self._send(401, {"error": "missing or invalid bearer token"})
                return False

            def do_GET(self):
                try:
                    if self._authorized("GET"):
                        api._handle_get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.fs.error(f"[api] GET {self.path} error: {e}")
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    if self._authorized("POST"):
                        api._handle_post(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.fs.error(f"[api] POST {self.path} error: {e}")
                    self._send(500, {"error": str(e)})

            def do_DELETE(self):
                try:
                    if self._authorized("DELETE"):
                        api._handle_delete(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": str(e)})

        # TLS for the control plane (reference analog: stunnel in front of
        # Flask, Dockerfile:24-35); cert shares the receiver's machinery.
        # The handshake MUST happen in the per-connection handler thread, not
        # on the listener: wrapping the listening socket makes SSLSocket
        # .accept() handshake synchronously in the single accept thread with
        # no timeout, so one idle TCP connect would wedge the whole API.
        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            handshake_timeout = 10.0

            def finish_request(self_srv, request, client_address):
                if ssl_ctx is not None:
                    try:
                        request.settimeout(self_srv.handshake_timeout)
                        request = ssl_ctx.wrap_socket(request, server_side=True)
                        request.settimeout(None)
                    except (OSError, TimeoutError) as e:  # covers ssl.SSLError
                        logger.fs.warning(f"[api] TLS handshake failed from {client_address}: {e}")
                        try:
                            request.close()
                        except OSError:
                            pass
                        return
                ThreadingHTTPServer.finish_request(self_srv, request, client_address)

        self._httpd = _Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="gateway-api", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() handshakes with serve_forever and blocks forever if the
        # serving thread never started
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()

    # ---- status-queue pump (called from the daemon main loop) ----

    #: retained chunk-state transition records (the aggregate status MAP is
    #: unbounded by design — completion accounting needs it — but the per-
    #: operator transition LOG is debugging data and keeps only its tail)
    MAX_STATUS_LOG = 65536

    def pull_chunk_status_queue(self) -> int:
        """Drain operator status records; account terminal completions; GC
        fully-complete chunk files. Returns records processed."""
        n = 0
        while True:
            try:
                rec = self.chunk_store.chunk_status_queue.get_nowait()
            except queue.Empty:
                break
            n += 1
            with self._lock:
                self.chunk_status_log.append(rec)
                if len(self.chunk_status_log) > self.MAX_STATUS_LOG:
                    overflow = len(self.chunk_status_log) - self.MAX_STATUS_LOG
                    del self.chunk_status_log[:overflow]
                    self._status_log_dropped += overflow
                chunk_id = rec["chunk_id"]
                partition = rec.get("partition", "default")
                state = rec["state"]
                handle = rec.get("handle")
                terminals = self.terminal_operators.get(partition, [])
                group = self.handle_to_group.get(partition, {}).get(handle, handle)
                if state == ChunkState.complete.to_short_str():
                    if group in terminals:
                        done = self._terminal_done.setdefault(chunk_id, set())
                        done.add(group)
                        if len(done) == len(terminals):
                            self.chunk_status[chunk_id] = "complete"
                            self._redriving.discard(chunk_id)  # re-drive pass landed
                            self._gc_chunk(chunk_id)
                        elif self.chunk_status.get(chunk_id) != "complete":
                            # a re-driven chunk mid-pass stays 'complete':
                            # the aggregate status NEVER regresses an acked
                            # chunk (sink-measured truth, docs/blast.md)
                            self.chunk_status[chunk_id] = "partial"
                    # a NON-terminal complete (e.g. WaitReceiver before the
                    # write) must never set the aggregate to 'complete' — the
                    # tracker would read the destination mid-write
                elif state == ChunkState.failed.to_short_str():
                    # a failed RE-drive pass never regresses a chunk whose
                    # bytes landed durably on the first pass — and always
                    # releases the re-drive guard so a later requeue may
                    # retry (blast healing; docs/blast.md)
                    redriving = chunk_id in self._redriving
                    self._redriving.discard(chunk_id)
                    if not (redriving and self.chunk_status.get(chunk_id) == "complete"):
                        self.chunk_status[chunk_id] = "failed"
                elif chunk_id not in self.chunk_status or self.chunk_status[chunk_id] not in ("complete", "partial"):
                    self.chunk_status[chunk_id] = state
        return n

    def _gc_chunk(self, chunk_id: str) -> None:
        for suffix in (".chunk", ".done", ".hdr"):
            p = self.chunk_store.chunk_dir / f"{chunk_id}{suffix}"
            if p.exists():
                try:
                    p.unlink()
                except OSError:
                    pass
        # sealed-frame cache entries (raw-forward) go through the
        # refcount-aware discard: an in-flight sendfile borrow defers the
        # unlink to its last close instead of tearing the frame mid-splice
        self.chunk_store.sealed_discard(chunk_id)

    def record_error(self, tb: str) -> None:
        with self._lock:
            self._errors.append(tb)

    # ---- drain accounting (docs/provisioning.md "Repair & drain") ----

    def incomplete_count(self) -> int:
        """Admitted chunks not yet complete/failed at this gateway — the
        drain loop's flush condition (failed chunks cannot flush; waiting on
        them would burn the whole drain deadline for nothing)."""
        with self._lock:
            return sum(
                1 for cid in self.chunk_requests if self.chunk_status.get(cid) not in ("complete", "failed")
            )

    def complete_count(self) -> int:
        with self._lock:
            return sum(1 for cid in self.chunk_requests if self.chunk_status.get(cid) == "complete")

    # ---- routing ----

    @staticmethod
    def _split_route(req):
        """(path, parsed query) — query strings must not break route matching."""
        from urllib.parse import parse_qs

        raw_path, _, query = req.path.partition("?")
        return raw_path.rstrip("/"), parse_qs(query)

    def _handle_get(self, req) -> None:
        path, query = self._split_route(req)
        if path == "/api/v1/status":
            req._send(
                200,
                {
                    "status": "ok",
                    "region": self.region,
                    "gateway_id": self.gateway_id,
                    "error": self.error_event.is_set(),
                    # a draining gateway is alive but closed to new chunks —
                    # the tracker reads this to route requeues/reshards away
                    # and to pre-warm a replacement (docs/provisioning.md)
                    "draining": bool(self.draining_event is not None and self.draining_event.is_set()),
                },
            )
        elif path == "/api/v1/chunk_requests":
            with self._lock:
                req._send(200, {"chunk_requests": list(self.chunk_requests.values()), "status": dict(self.chunk_status)})
        elif path == "/api/v1/incomplete_chunk_requests":
            with self._lock:
                incomplete = {
                    cid: cr for cid, cr in self.chunk_requests.items() if self.chunk_status.get(cid) != "complete"
                }
                req._send(200, {"chunk_requests": list(incomplete.values())})
        elif path == "/api/v1/chunk_status_log":
            # the tracker polls this every 100ms: by default return only the
            # aggregate chunk_id -> state map. The full transition log grows
            # O(chunks x operators) and serializing it per poll made control
            # traffic quadratic on large transfers; fetch it explicitly with
            # ?include_log=1 (debugging / profiling). ?chunk_ids=a,b,c
            # narrows the map to the poller's in-flight set — on long-lived
            # daemons the cumulative map itself grows O(total chunks ever)
            # and copying+serializing it per poll starved the API thread
            # under data-plane load (round-5 100 GB soak: control polls
            # timing out past ~90 waves).
            include_log = query.get("include_log") == ["1"]
            want_ids = query.get("chunk_ids")
            with self._lock:
                if want_ids:
                    ids = want_ids[0].split(",")
                    status = {cid: self.chunk_status[cid] for cid in ids if cid in self.chunk_status}
                else:
                    status = dict(self.chunk_status)
                payload = {"chunk_status": status}
                if include_log:
                    payload["chunk_status_log"] = list(self.chunk_status_log)
                    payload["status_log_dropped"] = self._status_log_dropped
                req._send(200, payload)
        elif path == "/api/v1/tenants":
            # tenant/job registry snapshot: active jobs, per-tenant chunk and
            # byte accounting, scheduler token usage (docs/multitenancy.md)
            if self.tenant_registry is None:
                req._send(200, {"tenants": {}, "jobs": {}})
            else:
                req._send(200, self.tenant_registry.snapshot())
        elif path == "/api/v1/errors":
            while True:
                try:
                    self._errors.append(self.error_queue.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                req._send(200, {"errors": list(self._errors)})
        elif path == "/api/v1/profile/socket/receiver":
            events = []
            while True:
                try:
                    events.append(self.receiver.socket_profile_events.get_nowait())
                except queue.Empty:
                    break
            # events_dropped: how many per-chunk events the bounded profile
            # queue discarded since startup — a nonzero value means this
            # drain is a SAMPLE of the traffic, not a complete record
            req._send(200, {"events": events, "events_dropped": self.receiver.socket_events_dropped()})
        elif path == "/api/v1/profile/socket/sender":
            # {"events": [...], "counters": {...}} — the counters follow the
            # stable SENDER_WIRE_COUNTER_ZERO schema (docs/datapath-performance.md)
            profile = self.sender_profile_fn()
            if isinstance(profile, list):  # legacy events-only provider
                profile = {"events": profile, "counters": {}}
            req._send(200, profile)
        elif path == "/api/v1/profile/compression":
            req._send(200, self.compression_stats_fn())
        elif path == "/api/v1/profile/decode":
            # receiver decode-path health: stable counter schema (the decode
            # mirror of /profile/compression) + per-chunk decode events
            events = []
            while True:
                try:
                    events.append(self.receiver.decode_profile_events.get_nowait())
                except queue.Empty:
                    break
            req._send(200, {"counters": self.receiver.decode_counters(), "events": events})
        elif path == "/api/v1/events":
            # flight-recorder tail (docs/observability.md): seq-ordered fleet
            # events since the caller's cursor. The recorder id lets a
            # collector de-duplicate when several in-process gateways share
            # one recorder (the loopback harness).
            from skyplane_tpu_torch.obs import get_recorder

            try:
                since = int(query.get("since", ["0"])[0] or 0)
            except ValueError:
                since = 0
            rec = get_recorder()
            req._send(
                200,
                {
                    "recorder": rec.recorder_id,
                    "gateway_id": self.gateway_id,
                    "events": rec.events_since(since),
                    "next_since": rec.seq(),
                    "dropped": rec.counters()["events_dropped"],
                },
            )
        elif path == "/api/v1/profile/cpu":
            # per-thread CPU seconds: the bottleneck report's "which thread
            # burned the core" input (ROADMAP item 1's multi-core question)
            req._send(200, self._cpu_payload())
        elif path == "/api/v1/profile/stacks":
            # sampling-profiler export (docs/observability.md "Core-time
            # profiling"): folded stacks + speedscope JSON + the core-budget
            # summary. Disabled -> enabled:false with empty tables, so the
            # route is always scrape-safe; ?summary=1 skips the stack tables
            # (the cheap form the collector's fallback path uses).
            from skyplane_tpu_torch.obs import get_profiler

            prof = get_profiler()
            payload = {
                "gateway_id": self.gateway_id,
                "region": self.region,
                # pump-aware: the daemon's summary fn folds worker-process
                # profiles in, so cores_effective reflects the whole gateway
                "summary": self.profile_summary_fn(),
            }
            if query.get("summary") != ["1"]:
                payload["folded"] = prof.folded()
                payload["speedscope"] = prof.speedscope()
            req._send(200, payload)
        elif path == "/api/v1/profile/locks":
            # lock hold/contention profile + the observed acquisition-order
            # graph from the runtime witness (SKYPLANE_TPU_LOCKCHECK=1;
            # docs/debugging.md "deadlock triage"). Disabled -> enabled:false
            # with empty tables, so the route is always scrape-safe.
            from skyplane_tpu_torch.obs.lockwitness import lock_profile

            req._send(
                200,
                {
                    "gateway_id": self.gateway_id,
                    "region": self.region,
                    **lock_profile(),
                },
            )
        elif path == "/api/v1/telemetry":
            # combined collector scrape (docs/observability.md): every fleet-
            # telemetry surface in ONE round trip. The TelemetryCollector
            # polls this each interval — four separate requests per gateway
            # per wave would spend more CPU on HTTP machinery than on the
            # payloads (the <2% collector-overhead budget).
            from skyplane_tpu_torch.obs import get_recorder

            try:
                since = int(query.get("since", ["0"])[0] or 0)
            except ValueError:
                since = 0
            rec = get_recorder()
            payload = {
                "gateway_id": self.gateway_id,
                "region": self.region,
                "metrics_text": self.metrics_fn(),
                "trace": self.trace_fn(),
                "events": {
                    "recorder": rec.recorder_id,
                    "events": rec.events_since(since),
                    "next_since": rec.seq(),
                    "dropped": rec.counters()["events_dropped"],
                },
            }
            if query.get("cpu") == ["1"]:
                payload["cpu"] = self._cpu_payload()
            if query.get("profile") == ["1"]:
                # core-budget summary only (stage CPU seconds, GIL wait,
                # cores_effective) — the full stack tables stay behind
                # /profile/stacks so the per-interval scrape stays small.
                # Pump-aware: worker-process profiles fold in.
                payload["profile"] = self.profile_summary_fn()
            req._send(200, payload)
        elif path == "/api/v1/trace":
            # Chrome trace-event JSON from the process tracer: loads directly
            # in Perfetto / chrome://tracing (docs/observability.md). Empty
            # unless SKYPLANE_TPU_TRACE_SAMPLE > 0 on this gateway.
            req._send(200, self.trace_fn())
        elif path == "/api/v1/metrics":
            # Prometheus text exposition: the unified MetricsRegistry view of
            # the DATAPATH/DECODE/SENDER_WIRE schemas + native gauges/histograms
            req._send_text(200, self.metrics_fn(), "text/plain; version=0.0.4; charset=utf-8")
        elif path.startswith("/api/v1/segment/"):
            # dedup-fabric peer fetch (docs/dedup-fabric.md): the ring owner
            # serves one segment by fingerprint — SegmentStore peek, sealed
            # raw path, or pump-shard spill file. Binary response; 404 = the
            # owner is healthy but cold (the fetcher treats it as a plain
            # miss, NOT a breaker strike).
            fp = _parse_fp(path.rsplit("/", 1)[1])
            if self.fabric is None or fp is None:
                req._send(404, {"error": "no dedup fabric on this gateway" if self.fabric is None else "malformed fingerprint"})
            else:
                data = self.fabric.serve(fp)
                if data is None:
                    req._send(404, {"error": "segment not resident"})
                else:
                    req._send_bytes(200, data)
        elif path == "/api/v1/fabric/summary":
            # gossip pull: this gateway's recently-proved fingerprints plus
            # the membership view (introspection for soaks and operators)
            if self.fabric is None:
                req._send(404, {"error": "no dedup fabric on this gateway"})
            else:
                out = self.fabric.summary()
                out["membership"] = self.fabric.membership()
                out["counters"] = self.fabric.counters()
                req._send(200, out)
        elif path == "/api/v1/logs":
            # live daemon log tail (reference analog: the dozzle container log
            # viewer on :8888); ?bytes=N bounds the tail (default 64 KiB,
            # capped at 8 MiB so one request can't slurp a multi-GB log)
            from skyplane_tpu_torch.utils.logger import _LOG_DIR

            try:
                n = int(query.get("bytes", ["65536"])[0])
            except ValueError:
                n = 65536
            n = max(0, min(n, 8 << 20))
            log_file = _LOG_DIR / "client.log"
            if not log_file.exists():
                req._send(200, {"log": "", "path": str(log_file)})
            else:
                size = log_file.stat().st_size
                with open(log_file, "rb") as f:
                    f.seek(max(0, size - n))
                    tail = f.read().decode(errors="replace")
                req._send(200, {"log": tail, "path": str(log_file), "size": size})
        else:
            req._send(404, {"error": f"no route {req.path}"})

    def _cpu_payload(self) -> dict:
        """Per-thread CPU seconds of the daemon process, plus — when the
        multi-process pump runs — per-worker-process CPU rows and a
        process_cpu_s that SUMS parent and workers, so monitor's cpu column
        and the bottleneck report's attribution cover the whole gateway."""
        import time as _time

        from skyplane_tpu_torch.obs.metrics import thread_cpu_seconds

        threads = thread_cpu_seconds()
        total = _time.process_time()
        if self.pump_cpu_fn is not None:
            try:
                workers = self.pump_cpu_fn() or {}
            except Exception:  # noqa: BLE001 — telemetry must not break the route
                workers = {}
            for name, s in sorted(workers.items()):
                threads[f"pump:{name}"] = {"tid": -1, "cpu_s": round(float(s), 6)}
                total += float(s)
        return {
            "gateway_id": self.gateway_id,
            "region": self.region,
            "threads": threads,
            "process_cpu_s": round(total, 6),
        }

    def _handle_post(self, req) -> None:
        path, _ = self._split_route(req)
        parts = path.split("/")
        if len(parts) == 6 and parts[:4] == ["", "api", "v1", "jobs"] and parts[5] == "heartbeat":
            # light TTL refresh for a LIVE job (service-mode controllers,
            # docs/service-mode.md): no tenant upsert, no scheduler push.
            # 404 = unknown (reaped or never admitted) — the caller must
            # re-admit through the full POST /jobs path, never assume
            # liveness; an already-swept slot stays swept.
            ok = self.tenant_registry is not None and self.tenant_registry.heartbeat_job(parts[4])
            req._send(200 if ok else 404, {"status": "ok" if ok else "unknown job"})
            return
        inj = get_injector()
        if inj.enabled and path in ("/api/v1/chunk_requests", "/api/v1/servers") and inj.fire("control.api"):
            # control-plane fault (docs/fault-injection.md): a transient 503
            # on the data-plane POSTs — dispatch/pre-registration retries via
            # the jittered RetryPolicy, and a sender's /servers failure rides
            # its stream's reconnect budget
            req._send(503, {"error": "injected control-API fault (retry)"})
            return
        if path == "/api/v1/shutdown":
            self.shutdown_requested.set()
            req._send(200, {"status": "shutting down"})
        elif path == "/api/v1/servers":
            # body (optional): {"source_gateway_id": ...} — lets the receiver
            # count distinct sources and advertise its dedup capacity so each
            # sender bounds its fingerprint index to a fair share (several
            # source gateways sharing one sink must not collectively believe
            # more segments resident than the sink can retain)
            try:
                body = req._read_json()
            except Exception:  # noqa: BLE001 — body is optional
                body = None
            src = (body or {}).get("source_gateway_id") if isinstance(body, dict) else None
            with self._lock:
                if src:
                    self._dedup_sources.add(str(src))
                n_sources = len(self._dedup_sources)
            port = self.receiver.start_server()
            resp = {"server_port": port, "n_sources": n_sources}
            store = getattr(self.receiver, "segment_store", None)
            if store is not None:
                resp["dedup_capacity_bytes"] = store.capacity_bytes
            req._send(200, resp)
        elif path == "/api/v1/jobs":
            # job admission: the front door of the multi-tenant gateway.
            # 429 (not 400) on a cap rejection so clients back off and retry.
            from skyplane_tpu_torch.tenancy import AdmissionError

            if self.tenant_registry is None:
                req._send(200, {"status": "ok", "note": "single-tenant api: admission is a no-op"})
                return
            body = req._read_json()
            job_id = str(body.get("job_id") or "")
            if not job_id:
                req._send(400, {"error": "job_id is required"})
                return
            from skyplane_tpu_torch.obs.events import EV_ADMISSION_GRANTED, EV_ADMISSION_REJECTED, get_recorder

            try:
                if self.tenant_policy_fn is not None and (body.get("weight") is not None or body.get("quotas")):
                    self.tenant_policy_fn(
                        body.get("tenant_id"), float(body.get("weight") or 1.0), body.get("quotas") or {}
                    )
                tenant_id = self.tenant_registry.admit_job(
                    body.get("tenant_id"), job_id, weight=body.get("weight"), quotas=body.get("quotas")
                )
            except AdmissionError as e:
                # 429s are exactly the kind of fleet event post-mortems need
                # in ONE ordered record (docs/observability.md flight recorder)
                get_recorder().record(
                    EV_ADMISSION_REJECTED,
                    gateway=self.gateway_id,
                    job_id=job_id,
                    tenant=str(body.get("tenant_id") or ""),
                    error=str(e)[:200],
                )
                req._send(429, {"error": str(e)})
                return
            get_recorder().record(
                EV_ADMISSION_GRANTED, gateway=self.gateway_id, job_id=job_id, tenant=tenant_id
            )
            req._send(200, {"status": "ok", "job_id": job_id, "tenant_id": tenant_id})
        elif path == "/api/v1/drain":
            # graceful drain entry point: operator-initiated (CLI / soak) or
            # the tracker simulating a preemption. Idempotent: a second POST
            # reports the drain already in progress.
            if self.drain_fn is None:
                req._send(501, {"error": "this gateway has no drain controller"})
                return
            try:
                body = req._read_json()
            except Exception:  # noqa: BLE001 — body is optional
                body = {}
            body = body if isinstance(body, dict) else {}
            started = self.drain_fn(
                reason=str(body.get("reason") or "control API request"),
                deadline_s=float(body["deadline_s"]) if body.get("deadline_s") is not None else None,
            )
            req._send(200, {"status": "draining", "started": bool(started)})
        elif path == "/api/v1/retarget":
            # applied replan (docs/provisioning.md): repoint sender operators
            # at a new next hop; streams cut over like a deliberate break
            if self.retarget_fn is None:
                req._send(501, {"error": "this gateway has no retarget controller"})
                return
            body = req._read_json()
            new_id = body.get("new_target_gateway_id")
            host = body.get("host")
            port = body.get("control_port")
            if not (new_id and host and port):
                req._send(400, {"error": "new_target_gateway_id, host and control_port are required"})
                return
            n = self.retarget_fn(
                str(new_id), str(host), int(port), old_target_gateway_id=body.get("old_target_gateway_id")
            )
            req._send(200, {"status": "ok", "retargeted": n})
        elif path == "/api/v1/requeue_chunks":
            # blast tree healing (docs/blast.md): re-DRIVE already-registered
            # chunks through this gateway's program without touching the
            # registration map — exactly-once registration is preserved (the
            # zero-duplicate-registrations invariant), while the re-enqueued
            # chunk re-reads/re-sends idempotently: receivers re-land the
            # same bytes atomically, sinks re-register as a no-op, and
            # write operators overwrite identical content. Body: a JSON list
            # of chunk ids; unknown ids are reported, never invented.
            body = req._read_json()
            if not isinstance(body, list):
                req._send(400, {"error": "expected a json list of chunk ids"})
                return
            requeued, pending, unknown = 0, 0, []
            for cid in body:
                cid = str(cid)
                with self._lock:
                    d = self.chunk_requests.get(cid)
                    if d is None:
                        unknown.append(cid)
                        continue
                    if self.chunk_status.get(cid) not in ("complete", "failed") or cid in self._redriving:
                        # still in flight through the program (or already
                        # being re-driven): the existing copy will finish —
                        # a second enqueue would race its own GC. FAILED
                        # chunks have NO in-flight copy and do re-drive.
                        pending += 1
                        continue
                    # fresh terminal refcount: GC waits for EVERY branch of
                    # the re-pass; the aggregate status stays 'complete'
                    self._terminal_done.pop(cid, None)
                    self._redriving.add(cid)
                cr = ChunkRequest.from_dict(d)
                self.chunk_store.add_chunk_request(cr, ChunkState.registered)
                requeued += 1
            req._send(200, {"status": "ok", "requeued": requeued, "pending": pending, "unknown": unknown})
        elif path == "/api/v1/chunk_requests":
            if self.draining_event is not None and self.draining_event.is_set():
                # DRAINING: admission stopped. 503 (not 4xx) so dispatch/
                # requeue retry ladders route the batch to a surviving
                # gateway instead of treating it as a client error.
                req._send(503, {"error": "gateway draining (preemption notice): admission stopped", "draining": True})
                return
            body = req._read_json()
            if not isinstance(body, list):
                req._send(400, {"error": "expected a json list of chunk requests"})
                return
            # two-pass: parse and admission-check EVERY entry before anything
            # enqueues — a rejection mid-list must not leave a silently
            # dispatched (and unaccounted) prefix running through the data
            # plane while the client is told the batch was refused
            parsed = []
            for d in body:
                cr = ChunkRequest.from_dict(d)
                tenant_id = validate_tenant_id(cr.chunk.tenant_id)
                if (
                    self.require_admission
                    and self.tenant_registry is not None
                    and not self.tenant_registry.has_active_job(tenant_id)
                ):
                    req._send(403, {"error": f"tenant {tenant_id} has no admitted job (POST /api/v1/jobs first)"})
                    return
                parsed.append((d, cr, tenant_id))
            n = 0
            tenant_acct: Dict[str, List[int]] = {}  # tenant -> [chunks, bytes]
            for d, cr, tenant_id in parsed:
                # claim the id and enqueue under one lock so a concurrent
                # duplicate POST can neither double-enqueue (TOCTOU) nor
                # see a recorded-but-never-queued chunk; roll the claim back
                # if enqueueing fails so the client's retry is honest
                with self._lock:
                    if cr.chunk.chunk_id in self.chunk_requests:
                        continue  # idempotent re-register
                    self.chunk_store.add_chunk_request(cr, ChunkState.registered)
                    # recorded only after a successful enqueue, atomically with it
                    self.chunk_requests[cr.chunk.chunk_id] = d
                acct = tenant_acct.setdefault(tenant_id, [0, 0])
                acct[0] += 1
                acct[1] += cr.chunk.chunk_length_bytes
                n += 1
            if self.tenant_registry is not None:
                for tenant_id, (n_chunks, n_bytes) in tenant_acct.items():
                    self.tenant_registry.note_chunks_registered(tenant_id, n_chunks, n_bytes)
            req._send(200, {"status": "ok", "registered": n})
        elif path == "/api/v1/upload_id_maps":
            body = req._read_json()
            self.upload_id_map_update(body)
            req._send(200, {"status": "ok", "entries": len(body)})
        elif path.startswith("/api/v1/segment/"):
            # dedup-fabric write-through landing: a peer whose literal's ring
            # owner is THIS gateway pushes the segment here. Raw binary body;
            # the fabric verifies content-vs-fingerprint before storing, so a
            # corrupt (or hostile) push can never poison the store.
            fp = _parse_fp(path.rsplit("/", 1)[1])
            length = int(req.headers.get("Content-Length", 0) or 0)
            data = req.rfile.read(length) if length else b""
            if self.fabric is None or fp is None:
                req._send(404, {"error": "no dedup fabric on this gateway" if self.fabric is None else "malformed fingerprint"})
            elif self.fabric.land(fp, data):
                req._send(200, {"status": "ok", "bytes": len(data)})
            else:
                req._send(422, {"error": "segment rejected (content/fingerprint mismatch or no store)"})
        elif path == "/api/v1/fabric/summary":
            # gossip push: absorb a peer's fingerprint summary into every
            # sender dedup index partition on this gateway (live operators,
            # pump workers, and indexes created later)
            if self.fabric is None:
                req._send(404, {"error": "no dedup fabric on this gateway"})
            else:
                body = req._read_json()
                req._send(200, {"status": "ok", "absorbed": self.fabric.absorb(body)})
        elif path == "/api/v1/fabric/membership":
            # fleet membership update (service controller / operator): full
            # document replace — ring rebuild, draining set, member table
            if self.fabric is None:
                req._send(404, {"error": "no dedup fabric on this gateway"})
            else:
                body = req._read_json()
                self.fabric.configure(body)
                req._send(200, {"status": "ok", "members": len(body.get("members") or [])})
        else:
            req._send(404, {"error": f"no route {req.path}"})

    def _handle_delete(self, req) -> None:
        path, _ = self._split_route(req)
        parts = path.split("/")
        if len(parts) == 5 and parts[:4] == ["", "api", "v1", "servers"]:
            ok = self.receiver.stop_server(int(parts[4]))
            req._send(200 if ok else 404, {"status": "ok" if ok else "unknown port"})
        elif len(parts) == 5 and parts[:4] == ["", "api", "v1", "jobs"]:
            ok = self.tenant_registry is not None and self.tenant_registry.finish_job(parts[4])
            if ok:
                from skyplane_tpu_torch.obs.events import EV_JOB_RELEASED, get_recorder

                get_recorder().record(EV_JOB_RELEASED, gateway=self.gateway_id, job_id=parts[4])
            req._send(200 if ok else 404, {"status": "ok" if ok else "unknown job"})
        else:
            req._send(404, {"error": f"no route {req.path}"})

    # injected by the daemon (write operators hold a reference to the dict)
    upload_id_map_update = staticmethod(lambda body: None)
