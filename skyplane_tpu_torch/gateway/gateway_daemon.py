"""Per-VM gateway daemon: builds the operator DAG from a gateway program and
pumps chunk state to the control API.

Reference parity: skyplane/gateway/gateway_daemon.py:34-359 — program/info
JSON loading, per-partition operator construction with mux queue wiring and
terminal-operator counting, worker startup, and the chunk-status pump loop.

Queue wiring rules (reference :126-308):
  * roots of a partition's operator forest read from the partition inbound
    queue (fed by POST /chunk_requests — either from the client or a remote
    sender's pre-registration);
  * ``mux_and`` children each get a replicated sub-queue (multicast);
  * ``mux_or`` (or any multi-child parent) children compete on one shared
    queue;
  * leaf operators are *terminal*: a chunk is done at this gateway when every
    terminal handle has processed it (explicit refcount in the API).

The port's daemon runs its data path on an explicit ``device`` (``"cuda"`` by
default; it raises without a card unless ``device="cpu"`` is asked for) and
hands it to the sender operators, the receiver and the batch runner. With
``SKYPLANE_TPU_PUMP_PROCS > 0`` the receiver and every sender run in pump
worker processes (``pump.py``) on the CPU, and the sender workers' codec
batches come back to this daemon's runner on the card. On a machine with
2^k >= 2 cards the runner shards its batches over a mesh of all of them
(``parallel/datapath_spmd.py``); ``SKYPLANE_TPU_SPMD=on`` builds a runner
even on a CPU daemon, ``off`` never shards.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from skyplane_tpu_torch.gateway.chunk_store import ChunkStore
from skyplane_tpu_torch.gateway.gateway_daemon_api import GatewayDaemonAPI
from skyplane_tpu_torch.gateway.gateway_queue import GatewayANDQueue, GatewayQueue
from skyplane_tpu_torch.gateway.operators.gateway_operator import (
    GatewayObjStoreReadOperator,
    GatewayObjStoreWriteOperator,
    GatewayOperator,
    GatewayRandomDataGenOperator,
    GatewayReadLocalOperator,
    GatewaySenderOperator,
    GatewayWaitReceiverOperator,
    GatewayWriteLocalOperator,
)
from skyplane_tpu_torch.gateway.operators.gateway_receiver import GatewayReceiver
from skyplane_tpu_torch.ops.backend import resolve_device
from skyplane_tpu_torch.ops.cdc import CDCParams
from skyplane_tpu_torch.ops.dedup import SegmentStore
from skyplane_tpu_torch.parallel.datapath_spmd import spmd_mode
from skyplane_tpu_torch.utils.logger import logger

def _iter_program_ops(program: dict):
    """Yield every op dict in a gateway program (depth-first)."""
    stack = [op for group in program.get("plan", []) for op in group.get("value", [])]
    while stack:
        op = stack.pop()
        yield op
        stack.extend(op.get("children", []))


class GatewayDaemon:
    def __init__(
        self,
        region: str,
        chunk_dir: str,
        gateway_program: dict,
        gateway_info: Dict[str, dict],
        gateway_id: str,
        control_port: int = 8081,
        bind_host: str = "0.0.0.0",
        e2ee_key: Optional[bytes] = None,
        use_tls: bool = True,
        cdc_params: Optional[CDCParams] = None,
        preempt_watch: Optional[bool] = None,
        device="cuda",
        batch_runner=None,
    ):
        self.device = resolve_device(device)
        self.region = region
        self.gateway_id = gateway_id
        self.gateway_info = gateway_info
        self.cdc_params = cdc_params or CDCParams()
        self.chunk_store = ChunkStore(chunk_dir)
        self.error_event = threading.Event()
        # graceful drain (docs/provisioning.md "Repair & drain"): set by an
        # announced preemption (PreemptionWatcher) or POST /api/v1/drain —
        # admission of new chunks stops, in-flight work flushes under
        # SKYPLANE_TPU_DRAIN_DEADLINE_S, then the daemon stops cleanly
        self.draining = threading.Event()
        self._drain_lock = threading.Lock()
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_started_monotonic: Optional[float] = None
        self._drain_reason = ""
        self._drain_flushed_chunks = 0
        # preempt_watch: True forces the watcher on (tests/harness), False
        # forces it off, None defers to SKYPLANE_TPU_PREEMPT_WATCH (a provider
        # name selecting the metadata probe, or "1"/"on" for fault-point-only)
        self.preempt_watch = preempt_watch
        self._preempt_watcher = None
        # sklint: disable=unbounded-queue-in-gateway -- the first error sets error_event which stops every producer; depth is bounded by the operator/thread count
        self.error_queue: "queue.Queue[str]" = queue.Queue()
        self.e2ee_key = e2ee_key
        self.use_tls = use_tls
        # dataplane-wide control-plane credentials ride in the info file's
        # reserved _meta entry (written by Dataplane.provision); the same
        # token authenticates inbound requests AND our calls to peer gateways
        from skyplane_tpu_torch.gateway.control_auth import INFO_META_KEY

        meta = gateway_info.get(INFO_META_KEY) or {}
        self.api_token: Optional[str] = meta.get("api_token")
        # control API rides TLS whenever the data sockets do
        self.control_tls = bool(meta.get("control_tls", use_tls))

        dedup_receive = any(
            op.get("op_type") == "receive" and op.get("dedup")
            for op in _iter_program_ops(gateway_program)
        )
        # relay gateways (receive feeding only sends) keep payloads opaque:
        # no decrypt/decode at intermediate hops (reference relay semantics).
        # The landing mode is a property of the single shared receiver, so a
        # program mixing relay-receives with decode-receives is rejected
        # loudly rather than corrupting the decode path.
        relay_receives, decode_receives = 0, 0
        for op in _iter_program_ops(gateway_program):
            if op.get("op_type") == "receive":
                subtree = list(_iter_program_ops({"plan": [{"value": op.get("children", [])}]}))
                has_send = any(o.get("op_type") == "send" for o in subtree)
                has_write = any(o.get("op_type", "").startswith("write") for o in subtree)
                if has_send and not has_write:
                    relay_receives += 1
                else:
                    decode_receives += 1
        if relay_receives and decode_receives:
            raise ValueError(
                "gateway program mixes relay-style receives (forward-only) with decode receives; "
                "split these across separate gateways"
            )
        raw_forward = relay_receives > 0

        # ---- multi-tenant control layer (tenancy/) ----
        # One gateway serves many concurrent jobs: a fair-share scheduler
        # arbitrates the scarce sender resources, a tenant/job registry does
        # admission + accounting, and (with dedup) a persistent cross-job
        # fingerprint index per target makes repeated corpora warm across
        # jobs and daemon restarts (docs/multitenancy.md).
        from skyplane_tpu_torch.tenancy import RES_CHUNK_SLOTS, RES_WIRE_BYTES, FairShareScheduler, TenantRegistry

        def _env_int(var: str, default: int, minimum: int = 1) -> int:
            try:
                return max(minimum, int(os.environ.get(var, str(default))))
            except ValueError:
                logger.fs.warning(f"ignoring malformed {var}; using {default}")
                return default

        self.scheduler = FairShareScheduler()
        self.scheduler.configure_resource(RES_WIRE_BYTES, _env_int("SKYPLANE_TPU_TENANT_WIRE_MB", 512) << 20)
        self.scheduler.configure_resource(RES_CHUNK_SLOTS, _env_int("SKYPLANE_TPU_TENANT_CHUNK_SLOTS", 64))
        self.tenants = TenantRegistry(
            scheduler=self.scheduler,
            max_jobs_total=_env_int("SKYPLANE_TPU_MAX_JOBS", 1024),
            max_jobs_per_tenant=_env_int("SKYPLANE_TPU_MAX_JOBS_PER_TENANT", 64),
        )
        # strict mode: chunks from tenants with no admitted job are rejected
        # (off by default — the loopback harness and legacy clients dispatch
        # chunks without a job registration)
        self.require_admission = os.environ.get("SKYPLANE_TPU_REQUIRE_ADMISSION", "0").strip() == "1"
        self.persist_dedup = os.environ.get("SKYPLANE_TPU_PERSIST_DEDUP", "1").strip().lower() not in ("0", "false", "off")
        self._tenant_index_quota = _env_int("SKYPLANE_TPU_TENANT_INDEX_QUOTA_MB", 0, minimum=0) << 20
        self._dedup_indexes: Dict[str, object] = {}  # target gateway id -> PersistentDedupIndex

        # multi-process byte pump (gateway/pump.py): 0 (default) = the
        # in-process thread data plane exactly as before; N>0 shards receiver
        # decode and sender framing/wire work across N spawn-context worker
        # processes each
        self.pump_procs = _env_int("SKYPLANE_TPU_PUMP_PROCS", 0, minimum=0)

        # one device batch runner per daemon, shared by every sender worker on
        # a CUDA gateway (micro-batches the CDC + fingerprint kernel calls).
        # Built BEFORE the receiver so paranoid recipe verification in the
        # decode pool batches through the same runner. A CPU gateway builds
        # none, as the JAX daemon off-accelerator builds none. A runner the
        # caller built (``batch_runner``, on this device: the sender and the
        # receiver refuse another) takes its place, so the runner path can be
        # driven on the CPU through the kernels' plain versions.
        self.batch_runner = batch_runner
        try:
            max_batch = int(os.environ.get("SKYPLANE_TPU_BATCH_CHUNKS", "8"))
        except ValueError:
            logger.fs.warning("ignoring malformed SKYPLANE_TPU_BATCH_CHUNKS; using 8")
            max_batch = 8
        # SKYPLANE_TPU_SPMD=on builds the runner even on a CPU daemon; =off
        # never builds a mesh (maybe_default_mesh returns None); auto shards
        # when the machine has a viable mesh of cards (2^k >= 2)
        mode = spmd_mode()
        if batch_runner is None and max_batch > 1 and mode != "off" and (self.device.type == "cuda" or mode == "on"):
            from skyplane_tpu_torch.ops.batch_runner import DeviceBatchRunner
            from skyplane_tpu_torch.parallel import datapath_spmd

            mesh = datapath_spmd.maybe_default_mesh(self.device)
            self.batch_runner = DeviceBatchRunner(
                cdc_params=self.cdc_params, max_batch=max_batch, device=self.device, gateway_id=gateway_id, mesh=mesh
            )
            if mesh is not None:
                logger.fs.info(f"[daemon {gateway_id}] batch runner sharded over mesh {dict(mesh.shape)}")

        self.receiver = GatewayReceiver(
            region=region,
            chunk_store=self.chunk_store,
            error_event=self.error_event,
            error_queue=self.error_queue,
            use_tls=use_tls,
            e2ee_key=e2ee_key,
            dedup=dedup_receive,
            segment_store=self._make_segment_store(chunk_dir) if dedup_receive else None,
            bind_host=bind_host,
            raw_forward=raw_forward,
            cdc_params=self.cdc_params,
            batch_runner=self.batch_runner,
            tenant_registry=self.tenants,
            gateway_id=gateway_id,
            device=self.device,
        )
        if self.pump_procs and any(op.get("op_type") == "receive" for op in _iter_program_ops(gateway_program)):
            # receiver shard pool only where the program actually receives —
            # a pure source/relay-origin gateway must not pay idle workers
            self.receiver.enable_pump(self.pump_procs, persist_dedup=self.persist_dedup)

        # ---- fleet-wide dedup fabric (dedup_fabric/) ----
        # Consistent-hash segment placement + peer fetch: membership comes
        # from SKYPLANE_TPU_FABRIC (pump workers inherit the env and build
        # their own instance) or arrives later via POST /fabric/membership.
        # Unconfigured, every hook below is inert.
        from skyplane_tpu_torch.dedup_fabric import fabric_from_env

        self.fabric = fabric_from_env(gateway_id, serve_spill_roots=[Path(chunk_dir) / "segments"])
        self.fabric.local_store = self.receiver.segment_store
        self.fabric.chunk_store = self.chunk_store
        if self.receiver.segment_store is not None:
            # receiver-side REF miss -> peer fetch before the NACK ladder;
            # landed literals feed write-through placement + gossip summary
            self.receiver.segment_store.fabric = self.fabric
        # absorbed peer summaries warm every sender index partition
        self.fabric.add_absorb_sink(self._absorb_fleet_fps)
        # dynamic membership pushes fan out to pump worker processes
        self.fabric.configure_listeners.append(self._broadcast_fabric_membership)
        # stale cross-shard warmth observed as NACKs (gossip said a fleet
        # member proved the fp; the receiver disagreed at send time)
        self._cross_shard_nacks = 0

        self.upload_id_map: Dict[str, str] = {}
        self.operators: List[GatewayOperator] = []
        # next-hop regions per target gateway, captured at operator
        # instantiation — the egress-cost provider prices byte edges with them
        self._target_regions: Dict[str, str] = {}
        self.terminal_operators: Dict[str, List[str]] = {}  # partition -> terminal group names
        self.handle_to_group: Dict[str, Dict[str, str]] = {}  # partition -> handle -> group
        self._or_counter = 0
        self._build_operators(gateway_program)

        ssl_ctx = None
        if self.control_tls:
            import ssl as _ssl

            from skyplane_tpu_torch.gateway.cert import generate_self_signed_certificate

            cert_dir = Path(chunk_dir) / "certs"
            cert, key = generate_self_signed_certificate(
                "skyplane-tpu-control", cert_dir / "api_cert.pem", cert_dir / "api_key.pem"
            )
            ssl_ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(certfile=str(cert), keyfile=str(key))
        # unified metrics registry (obs/): absorbs the three
        # legacy counter schemas behind one Prometheus endpoint. Layered on
        # the process-wide registry (where the receiver/sender histograms
        # live) so two in-process daemons — the loopback test harness —
        # never double-register a family.
        from skyplane_tpu_torch.obs import get_registry, get_tracer
        from skyplane_tpu_torch.obs.metrics import MetricsRegistry

        self.metrics = MetricsRegistry(parent=get_registry())
        self.metrics.register_provider("datapath", self._compression_stats)
        self.metrics.register_provider("decode", self.receiver.decode_counters)
        self.metrics.register_provider("sender_wire", self._sender_wire_counters)
        self.metrics.register_provider("trace", lambda: get_tracer().counters())
        # sampling profiler (docs/observability.md "Core-time profiling"):
        # off by default (SKYPLANE_TPU_PROFILE_HZ=0 -> NOOP, ensure_started
        # is a no-op); when armed, its sample/drop counters — including the
        # profile.sample_stall degradation signal — ride the same scrape
        from skyplane_tpu_torch.obs import get_profiler

        get_profiler().ensure_started()
        self.metrics.register_provider("profile", lambda: get_profiler().counters())
        # flight-recorder health (docs/observability.md): recorded/dropped/
        # buffered event counts ride the same scrape as everything else
        from skyplane_tpu_torch.obs import get_recorder

        self.metrics.register_provider("events", lambda: get_recorder().counters())
        # chaos visibility (docs/fault-injection.md): per-point fault firings
        # as skyplane_faults_injected{point="..."} — empty when faults are off
        from skyplane_tpu_torch.faults import get_injector

        self.metrics.register_labeled_provider(
            "faults", lambda: {"injected": get_injector().counters()}, label="point"
        )
        self.metrics.gauge("gateway_operators", help_="operators running in this daemon", fn=lambda: len(self.operators))
        # per-tenant families (docs/multitenancy.md) + the two soak-leak
        # gauges the eviction integration test asserts flat
        self.metrics.register_labeled_provider("tenant", self._tenant_counters)
        self.metrics.gauge(
            "index_rss_bytes",
            help_="resident bytes across dedup indexes and the segment-store memory tier",
            fn=self._index_rss_bytes,
        )
        from skyplane_tpu_torch.obs.metrics import open_fd_count

        self.metrics.gauge("process_open_fds", help_="open file descriptors of the daemon process", fn=open_fd_count)
        # multi-process pump health (docs/datapath-performance.md): always
        # present (zeros when the pump is off) as skyplane_pump_*
        self.metrics.register_provider("pump", self._pump_counters)
        # per-edge source-egress attribution (docs/blast.md): wire bytes
        # keyed by (src, dst) gateway so fan-out-vs-egress curves come from
        # counters, not arithmetic — skyplane_egress_bytes_total{src,dst}
        self.metrics.register_labeled_provider("egress", self._egress_edges, label=("src", "dst"))
        # live egress dollars (docs/observability.md, ROADMAP item 3): the
        # same per-edge byte counters priced through the region-pair grid
        # (planner/pricing.py) at scrape time — same (src,dst) gateway-id
        # labels as bytes_total, so $/TB joins are a one-line PromQL division.
        # Next-hop regions were captured at operator instantiation above.
        self.metrics.register_labeled_provider("egress", self._egress_cost_edges, label=("src", "dst"))
        # dedup-fabric health (docs/dedup-fabric.md): peer-fetch outcomes
        # (worker-process counters ride the decode snapshots), fetch latency,
        # cross-shard NACKs, and the raw fabric counter schema
        self.metrics.register_labeled_provider("peer_fetch", self._peer_fetch_results, label="result")
        self.fabric.fetch_observe = self.metrics.histogram(
            "peer_fetch_seconds",
            help_="peer segment fetch latency (ring-owner GET round trip)",
            buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
        ).observe
        self.metrics.gauge(
            "cross_shard_nacks_total",
            help_="NACKs on fingerprints warmed only by fleet gossip (stale cross-shard warmth)",
            fn=self._cross_shard_nacks_total,
        )
        self.metrics.register_provider("fabric", self._fabric_counters)
        self.api = GatewayDaemonAPI(
            chunk_store=self.chunk_store,
            receiver=self.receiver,
            error_event=self.error_event,
            error_queue=self.error_queue,
            terminal_operators=self.terminal_operators,
            handle_to_group=self.handle_to_group,
            region=region,
            gateway_id=gateway_id,
            host=bind_host,
            port=control_port,
            compression_stats_fn=self._compression_stats,
            sender_profile_fn=self._sender_socket_events,
            metrics_fn=self.metrics.render_prometheus,
            trace_fn=self._merged_trace_export,
            fabric=self.fabric,
            api_token=self.api_token,
            ssl_ctx=ssl_ctx,
            tenant_registry=self.tenants,
            tenant_policy_fn=self.apply_tenant_policy,
            require_admission=self.require_admission,
            draining_event=self.draining,
            drain_fn=self.begin_drain,
            retarget_fn=self.retarget_sender,
            # pump telemetry mux: /profile/stacks + /telemetry report the
            # gateway as parent + workers (cores-effective SUMS, so
            # `skyplane-tpu flame`/`monitor` see the whole gateway row)
            profile_summary_fn=self._merged_profile_summary,
            pump_cpu_fn=self._pump_worker_cpu if self.pump_procs else None,
        )
        self.api.upload_id_map_update = self._update_upload_ids
        self.api.device = str(self.device)

    # ---- construction ----

    def _make_segment_store(self, chunk_dir: str) -> SegmentStore:
        """Receiver segment store, sized by env for small-RAM gateways and
        eviction-pressure tests (defaults: 4 GiB memory + 32 GiB spill).
        With persistent dedup on, prior runs' spilled segments are adopted so
        sender indexes recovered from their journals actually resolve."""

        def _mb(var: str, default_mb: int) -> int:
            try:
                val = int(os.environ.get(var, str(default_mb)))
                if val <= 0:
                    raise ValueError(f"{val} <= 0")  # 0/negative would evict every segment on insert
                return val << 20
            except ValueError:
                logger.fs.warning(f"ignoring invalid {var}; using {default_mb} MB")
                return default_mb << 20

        return SegmentStore(
            max_bytes=_mb("SKYPLANE_TPU_SEGSTORE_MB", 4 << 10),
            spill_dir=Path(chunk_dir) / "segments",
            spill_max_bytes=_mb("SKYPLANE_TPU_SEGSTORE_SPILL_MB", 32 << 10),
            persistent_spill=self.persist_dedup,
        )

    def _dedup_index_for(self, target_gateway_id: str):
        """Shared persistent fingerprint index for one destination gateway:
        every sender operator targeting it (across all jobs/partitions) uses
        the SAME index, journaled under <chunk_dir>/dedup_index/<target> so
        warm fingerprints survive daemon restarts. None when persistence is
        off (the operator builds its own ephemeral SenderDedupIndex)."""
        if not self.persist_dedup:
            return None
        idx = self._dedup_indexes.get(target_gateway_id)
        if idx is None:
            from skyplane_tpu_torch.tenancy import PersistentDedupIndex

            idx = PersistentDedupIndex(
                Path(self.chunk_store.chunk_dir) / "dedup_index" / target_gateway_id,
                default_tenant_quota_bytes=self._tenant_index_quota or None,
            )
            self._dedup_indexes[target_gateway_id] = idx
            self._wire_index_to_fabric(idx)
            if idx.counters()["index_recovered_entries"]:
                logger.fs.info(
                    f"[daemon {self.gateway_id}] recovered {idx.counters()['index_recovered_entries']} "
                    f"warm fingerprints for target {target_gateway_id}"
                )
        return idx

    # ---- fleet dedup fabric plumbing (docs/dedup-fabric.md) ----

    def _wire_index_to_fabric(self, idx) -> None:
        """Attach one sender dedup index to the fabric: discarding a
        gossip-warmed fp counts a cross-shard NACK, and fps already absorbed
        from peer summaries seed the remote tier so indexes created after the
        gossip round still skip the literal."""
        idx.on_cross_shard_nack = self._note_cross_shard_nack
        seeded = self.fabric.absorbed_fps()
        if seeded:
            idx.add_remote(seeded, origin="fabric")

    def _note_cross_shard_nack(self, fp: bytes) -> None:
        self._cross_shard_nacks += 1  # plain int bump (GIL-atomic)

    def _cross_shard_nacks_total(self) -> float:
        """Parent-side discards (indexes wired above) plus pump sender
        workers' counts, which ride the merged wire-counter snapshots."""
        total = float(self._cross_shard_nacks)
        for op in self.operators:
            if isinstance(op, GatewaySenderOperator):
                total += op.wire_counters().get("cross_shard_nacks", 0)
        return total

    def _absorb_fleet_fps(self, batch, origin: str) -> None:
        """Fan one absorbed peer summary out to every sender dedup index
        partition: the daemon-shared persistent indexes, operator-private
        ephemeral indexes, and (over the ctrl channel) the pump sender
        workers' private partitions."""
        seen = set()
        for idx in self._dedup_indexes.values():
            if id(idx) not in seen:
                seen.add(id(idx))
                idx.add_remote(batch, origin=origin)
        for op in self.operators:
            idx = getattr(op, "dedup_index", None)
            if idx is not None and id(idx) not in seen and hasattr(idx, "add_remote"):
                seen.add(id(idx))
                idx.add_remote(batch, origin=origin)
        from skyplane_tpu_torch.gateway.pump import is_pump_sender

        msg = {"type": "fabric_fps", "fps": [[fp.hex(), size] for fp, size in batch], "origin": origin}
        for op in self.operators:
            if is_pump_sender(op) and getattr(op, "pool", None) is not None:
                op.pool.broadcast(msg)

    def _broadcast_fabric_membership(self, membership: dict) -> None:
        """Membership pushed to this daemon reaches pump worker processes
        (each runs its own DedupFabric bootstrapped from the inherited env)."""
        msg = {"type": "fabric", "membership": membership}
        for owner in self._pump_pools():
            pool = getattr(owner, "pool", None)
            if pool is not None:
                pool.broadcast(msg)

    def _peer_fetch_results(self) -> Dict[str, Dict[str, float]]:
        """skyplane_peer_fetch_total{result=hit|miss|timeout}: parent fabric
        counters plus receiver pump workers' (merged into decode snapshots)."""
        c = self.fabric.counters()
        dec = self.receiver.decode_counters()
        return {
            "total": {
                "hit": c["fabric_peer_fetch_hits"] + dec.get("fabric_peer_fetch_hits", 0),
                "miss": c["fabric_peer_fetch_misses"] + dec.get("fabric_peer_fetch_misses", 0),
                "timeout": c["fabric_peer_fetch_timeouts"] + dec.get("fabric_peer_fetch_timeouts", 0),
            }
        }

    def _fabric_counters(self) -> dict:
        # keys already carry the fabric_ prefix; strip it so the provider
        # renders skyplane_fabric_<key> instead of skyplane_fabric_fabric_*
        return {k[len("fabric_"):]: v for k, v in self.fabric.counters().items()}

    def apply_tenant_policy(self, tenant_id: str, weight: float = 1.0, quotas: Optional[Dict[str, int]] = None) -> str:
        """Admission-time policy push: registry + scheduler weights/caps, and
        per-tenant dedup-index byte quotas on every live persistent index."""
        tenant_id = self.tenants.register_tenant(tenant_id, weight=weight, quotas=quotas)
        index_quota = (quotas or {}).get("index_bytes")
        if index_quota is not None:
            for idx in self._dedup_indexes.values():
                idx.set_tenant_quota(tenant_id, int(index_quota))
        return tenant_id

    def _tenant_counters(self) -> Dict[str, Dict[str, float]]:
        """Labelled-provider food: {metric: {tenant: value}} merged from the
        registry, the fair-share scheduler, and the persistent indexes —
        rendered as skyplane_tenant_*{tenant="..."} on /api/v1/metrics."""
        out = self.tenants.tenant_counters()
        out.update(self.scheduler.tenant_counters())
        idx_bytes: Dict[str, float] = {}
        for idx in self._dedup_indexes.values():
            for tenant, n in idx.counters()["tenant_index_bytes"].items():
                idx_bytes[tenant] = idx_bytes.get(tenant, 0) + n
        out["index_bytes"] = idx_bytes
        return out

    def _index_rss_bytes(self) -> float:
        """Resident bytes across every dedup structure this daemon owns
        (sender fingerprint indexes + receiver segment-store memory tier) —
        the soak-flatness signal asserted in the eviction integration test."""
        total = 0
        seen = set()
        for idx in self._dedup_indexes.values():
            total += idx.counters()["index_bytes"]
            seen.add(id(idx))
        for op in self.operators:
            idx = getattr(op, "dedup_index", None)
            if idx is not None and id(idx) not in seen:
                seen.add(id(idx))
                total += getattr(idx, "_bytes", 0)  # plain int read (GIL-atomic)
        store = self.receiver.segment_store
        if store is not None:
            total += store.counters()["store_mem_bytes"]
        return float(total)

    def _update_upload_ids(self, body: Dict[str, str]) -> None:
        self.upload_id_map.update(body)

    # ---- multi-process pump telemetry mux (gateway/pump.py) ----

    def _pump_pools(self):
        """Every pump pool owner this daemon runs: the receiver pump plus
        any pump sender operators. Empty when SKYPLANE_TPU_PUMP_PROCS=0."""
        owners = []
        if self.receiver.pump is not None:
            owners.append(self.receiver.pump)
        from skyplane_tpu_torch.gateway.pump import is_pump_sender

        for op in self.operators:
            if is_pump_sender(op):
                owners.append(op)
        return owners

    def _pump_counters(self) -> dict:
        from skyplane_tpu_torch.gateway.pump import PUMP_COUNTER_ZERO

        out = dict(PUMP_COUNTER_ZERO)
        for owner in self._pump_pools():
            snap = owner.pump_counters() if hasattr(owner, "pump_counters") else owner.counters()
            for k in out:
                out[k] += snap.get(k, 0)
        return out

    def _merged_profile_summary(self) -> dict:
        """Parent profiler summary with every pump worker's pushed summary
        folded in — the gateway's TRUE core budget (cores-effective sums
        across processes; docs/observability.md)."""
        from skyplane_tpu_torch.obs import get_profiler
        from skyplane_tpu_torch.obs.profiler import merge_profile_summaries

        summaries = []
        for owner in self._pump_pools():
            summaries.extend(owner.profile_summaries())
        return merge_profile_summaries(get_profiler().summary(), summaries)

    def _merged_trace_export(self) -> dict:
        """Parent tracer export plus every pump worker's pushed span-ring
        snapshot: /api/v1/trace covers the whole gateway, and the collector's
        args.gateway regrouping (workers stamp the parent id) keeps one
        Perfetto row per gateway regardless of process count."""
        from skyplane_tpu_torch.obs import get_tracer

        export = get_tracer().export()
        for owner in self._pump_pools():
            extra = owner.trace_events()
            if extra:
                export["traceEvents"] = list(export.get("traceEvents", [])) + extra
        return export

    def _pump_worker_cpu(self) -> Dict[str, float]:
        """Per-worker process CPU seconds for /profile/cpu and the combined
        telemetry scrape — monitor's cpu column must reflect the sum of
        workers, not just the parent."""
        out: Dict[str, float] = {}
        for owner in self._pump_pools():
            for name, s in owner.worker_cpu_s().items():
                out[name] = out.get(name, 0.0) + s
        return out

    def _egress_edges(self) -> Dict[str, Dict[tuple, float]]:
        """{metric: {(src, dst): bytes}} for the edge-labeled provider. The
        multi-process pump keeps its wire work in worker processes, so pump
        senders attribute their merged wire_bytes_sent to the operator's
        current target — single-target-per-operator by construction."""
        from skyplane_tpu_torch.gateway.pump import is_pump_sender

        edges: Dict[tuple, float] = {}
        for op in self.operators:
            if not isinstance(op, GatewaySenderOperator):
                continue
            per_edge = op.egress_by_edge()
            if not per_edge and is_pump_sender(op):
                per_edge = {op.target_gateway_id: op.wire_counters().get("wire_bytes_sent", 0)}
            for dst, n in per_edge.items():
                key = (self.gateway_id, dst)
                edges[key] = edges.get(key, 0) + n
        return {"bytes_total": edges}

    def _egress_cost_edges(self) -> Dict[str, Dict[tuple, float]]:
        """skyplane_egress_cost_dollars_total{src,dst}: per-edge wire bytes
        priced through the region-pair egress grid at scrape time. Cumulative
        like its byte counterpart (price x monotone bytes), so rate() and
        increase() behave; an edge whose next-hop region was never learned
        prices as same-provider intra-cloud ($0 on local/loopback fleets)."""
        from skyplane_tpu_torch.planner.pricing import get_egress_cost_per_gb

        edges = self._egress_edges().get("bytes_total", {})
        cost: Dict[tuple, float] = {}
        for (src, dst), n in edges.items():
            dst_region = self._target_regions.get(dst, self.region)
            per_gb = get_egress_cost_per_gb(self.region, dst_region)
            cost[(src, dst)] = (n / 1e9) * per_gb
        return {"cost_dollars_total": cost}

    def _sender_socket_events(self) -> dict:
        """Per-window send profile events + the stable wire-counter schema
        from every sender operator (sender-side analog of the receiver
        socket/decode profilers): GET /api/v1/profile/socket/sender."""
        from skyplane_tpu_torch.gateway.operators.sender_wire import SENDER_WIRE_COUNTER_ZERO

        events = []
        counters = dict(SENDER_WIRE_COUNTER_ZERO)
        for op in self.operators:
            if isinstance(op, GatewaySenderOperator):
                while True:
                    try:
                        events.append(op.socket_profile_events.get_nowait())
                    except queue.Empty:
                        break
                per_op = op.wire_counters()
                for k in counters:
                    counters[k] += per_op.get(k, 0)
        return {"events": events, "counters": counters}

    def _sender_wire_counters(self) -> dict:
        """Wire counters only (no event-queue drain — the MetricsRegistry
        provider must be side-effect free so a scrape never steals the
        profile events /profile/socket/sender serves)."""
        from skyplane_tpu_torch.gateway.operators.sender_wire import SENDER_WIRE_COUNTER_ZERO

        counters = dict(SENDER_WIRE_COUNTER_ZERO)
        for op in self.operators:
            if isinstance(op, GatewaySenderOperator):
                per_op = op.wire_counters()
                for k in counters:
                    counters[k] += per_op.get(k, 0)
        return counters

    def _compression_stats(self) -> dict:
        from skyplane_tpu_torch.ops.pipeline import DataPathStats

        agg = {k: 0 for k in DataPathStats._KEYS}
        hot_path = dict(DataPathStats.EXTERNAL_ZERO)  # pool / batch / donation counters
        for op in self.operators:
            if isinstance(op, GatewaySenderOperator):
                d = op.datapath_counters()  # pump operators merge worker-process stats
                for k in agg:
                    agg[k] += d.get(k, 0)
                if self.batch_runner is None:
                    # per-processor pools: summing is correct (nothing shared);
                    # derived ratios are recomputed from the summed counts below
                    for k in hot_path:
                        if k not in ("pool_hit_rate", "batch_occupancy"):
                            hot_path[k] = hot_path.get(k, 0) + d.get(k, 0)
        if self.batch_runner is None:
            lookups = hot_path["pool_hits"] + hot_path["pool_misses"]
            hot_path["pool_hit_rate"] = round(hot_path["pool_hits"] / lookups, 4) if lookups else 0.0
        if self.batch_runner is not None:
            # ONE runner (and pool) shared by every sender operator: read its
            # counters once — summing each operator's copy would multiply them
            hot_path.update(self.batch_runner.counters())
        agg["compression_ratio"] = (agg["raw_bytes"] / agg["wire_bytes"]) if agg["wire_bytes"] else 1.0
        agg.update(hot_path)
        return agg

    def _build_operators(self, program: dict) -> None:
        for group in program.get("plan", []):
            partitions = group["partitions"]
            roots = group["value"]
            for pid in partitions:
                inbound = GatewayQueue()
                self.chunk_store.add_partition(pid, inbound)
                terminals: List[str] = []
                handle_groups: Dict[str, str] = {}
                for root in roots:
                    self._walk(root, inbound, pid, terminals, handle_groups, group_label=None)
                self.terminal_operators[pid] = sorted(set(terminals))
                self.handle_to_group[pid] = handle_groups

    def _make_output_queue(self, children: List[dict]) -> Tuple[Optional[GatewayQueue], List[Tuple[dict, GatewayQueue, Optional[str]]]]:
        """Decide this op's output queue and each child's (input queue, terminal
        group). Children under mux_or compete for chunks, so they share ONE
        terminal group (any-of completion); mux_and branches each form their
        own group (all-of completion)."""
        if not children:
            return None, []
        if len(children) == 1 and children[0]["op_type"] == "mux_and":
            and_q = GatewayANDQueue()
            return and_q, [(gc, and_q, None) for gc in children[0].get("children", [])]
        if len(children) == 1 and children[0]["op_type"] == "mux_or":
            shared = GatewayQueue()
            self._or_counter += 1
            or_group = children[0].get("handle") or f"or_group_{self._or_counter}"
            return shared, [(gc, shared, or_group) for gc in children[0].get("children", [])]
        shared = GatewayQueue()
        self._or_counter += 1
        or_group = f"or_group_{self._or_counter}"
        return shared, [(c, shared, or_group) for c in children]

    def _walk(
        self,
        op: dict,
        input_queue: GatewayQueue,
        pid: str,
        terminals: List[str],
        handle_groups: Dict[str, str],
        group_label: Optional[str],
    ) -> None:
        op_type = op["op_type"]
        handle = op.get("handle") or f"{op_type}_{len(self.operators)}"
        if op_type in ("mux_and", "mux_or"):
            # a mux at the root: wire its children straight to the inbound queue semantics
            out_q, child_wiring = self._make_output_queue([op])
            # forward every inbound chunk into the mux queue via a trivial pump
            self._spawn_pump(input_queue, out_q, handle)
            for child, q, child_group in child_wiring:
                self._walk(child, q, pid, terminals, handle_groups, child_group)
            return

        children = op.get("children", [])
        output_queue, child_wiring = self._make_output_queue(children)
        operator = self._instantiate(op_type, op, handle, input_queue, output_queue)
        self.operators.append(operator)
        if not child_wiring:
            group = group_label or handle
            terminals.append(group)
            handle_groups[handle] = group
        for child, q, child_group in child_wiring:
            # once inside an or-competition branch, all downstream leaves stay in
            # that group — each chunk traverses exactly one competing branch
            effective = group_label if group_label is not None else child_group
            self._walk(child, q, pid, terminals, handle_groups, effective)

    def _spawn_pump(self, src: GatewayQueue, dst: GatewayQueue, handle: str) -> None:
        src.register_handle(handle)

        def pump():
            while not self.error_event.is_set():
                try:
                    dst.put(src.pop(handle, timeout=0.25))
                except queue.Empty:
                    continue

        threading.Thread(target=pump, name=f"pump-{handle}", daemon=True).start()

    def _instantiate(
        self, op_type: str, op: dict, handle: str, input_queue: GatewayQueue, output_queue: Optional[GatewayQueue]
    ) -> GatewayOperator:
        common = dict(
            handle=handle,
            region=self.region,
            input_queue=input_queue,
            output_queue=output_queue,
            error_event=self.error_event,
            error_queue=self.error_queue,
            chunk_store=self.chunk_store,
            gateway_id=self.gateway_id,
        )
        if op_type == "receive":
            return GatewayWaitReceiverOperator(**common, n_workers=4)
        if op_type == "read_object_store":
            return GatewayObjStoreReadOperator(
                **common,
                n_workers=op.get("num_connections", 16),
                bucket_name=op["bucket_name"],
                bucket_region=op["bucket_region"],
            )
        if op_type == "write_object_store":
            return GatewayObjStoreWriteOperator(
                **common,
                n_workers=op.get("num_connections", 16),
                bucket_name=op["bucket_name"],
                bucket_region=op["bucket_region"],
                upload_id_map=self.upload_id_map,
            )
        if op_type == "read_local":
            return GatewayReadLocalOperator(**common, n_workers=op.get("num_connections", 8))
        if op_type == "write_local":
            # `path` re-anchors dest_key under a sink-local root (blast
            # fan-out: many sinks land the same dest_key side by side)
            return GatewayWriteLocalOperator(**common, n_workers=4, root=op.get("path"))
        if op_type == "gen_data":
            return GatewayRandomDataGenOperator(**common, n_workers=4)
        if op_type == "send":
            target_id = op["target_gateway_id"]
            info = self.gateway_info.get(target_id, {})
            host = info.get("private_ip") if op.get("private_ip") else info.get("public_ip")
            host = host or info.get("public_ip") or info.get("private_ip")
            if not host:
                raise ValueError(f"no address for target gateway {target_id}")
            # next-hop region for the egress-cost provider: the program's
            # region tag first (planner truth), gateway_info as fallback
            region_tag = op.get("region") or info.get("region")
            if region_tag:
                self._target_regions[target_id] = str(region_tag)
            dedup = op.get("dedup", False)
            sender_cls = GatewaySenderOperator
            sender_extra = {}
            if self.pump_procs:
                # multi-process pump: framing + codec + wire work runs in
                # worker processes; each worker keeps a PRIVATE dedup-index
                # partition (the daemon-shared persistent index is not
                # multi-process safe), so no shared index is injected here
                from skyplane_tpu_torch.gateway.pump import make_sender_pump_operator

                sender_cls = make_sender_pump_operator
                sender_extra = {"pump_procs": self.pump_procs}
            sender = sender_cls(
                **common,
                **sender_extra,
                n_workers=op.get("num_connections", 16),
                target_gateway_id=target_id,
                target_host=host,
                target_control_port=info.get("control_port", 8081),
                codec_name=op.get("compress", "none") or "none",
                dedup=dedup,
                cdc_params=self.cdc_params,
                e2ee_key=self.e2ee_key if op.get("encrypt") else None,
                use_tls=self.use_tls,
                batch_runner=self.batch_runner,
                window=int(os.environ.get("SKYPLANE_TPU_SENDER_WINDOW", op.get("window", 16))),
                # byte bound on each stream's in-flight window (docs/
                # configuration.md): WAN tuning + the replan tests, which
                # need frames to FLOW over time rather than burst at once
                window_bytes=int(os.environ.get("SKYPLANE_TPU_SENDER_WINDOW_MB", "256")) << 20,
                api_token=self.api_token,
                control_tls=self.control_tls,
                source_gateway_id=self.gateway_id,
                peer_serve=op.get("peer_serve", False),
                raw_forward=op.get("raw_eligible"),
                dedup_index=self._dedup_index_for(target_id) if dedup and not self.pump_procs else None,
                scheduler=self.scheduler,
                tenant_registry=self.tenants,
                device=self.device,
            )
            # operator-private ephemeral indexes (persistence off) still join
            # the fabric: gossip warmth in, cross-shard NACK accounting out
            idx = getattr(sender, "dedup_index", None)
            if idx is not None and getattr(idx, "on_cross_shard_nack", False) is None:
                self._wire_index_to_fabric(idx)
            return sender
        raise ValueError(f"unknown operator type {op_type!r}")

    # ---- graceful drain + applied replans (docs/provisioning.md) ----

    def retarget_sender(
        self, new_target_gateway_id: str, host: str, control_port: int, old_target_gateway_id: Optional[str] = None
    ) -> int:
        """Applied replan: repoint sender operators at a new next hop. With
        ``old_target_gateway_id`` only matching senders cut over; without it
        every sender does (the single-send-op common case). Returns the
        number of operators retargeted."""
        n = 0
        for op in self.operators:
            if not isinstance(op, GatewaySenderOperator):
                continue
            if old_target_gateway_id is not None and op.target_gateway_id != old_target_gateway_id:
                continue
            new_index = self._dedup_index_for(new_target_gateway_id) if op.dedup_index is not None else None
            n += op.retarget(new_target_gateway_id, host, control_port, dedup_index=new_index)
        if n:
            logger.fs.warning(
                f"[daemon {self.gateway_id}] replan cutover applied: {n} sender operator(s) now target "
                f"{new_target_gateway_id} at {host}:{control_port}"
            )
        return n

    def begin_drain(self, reason: str = "operator request", deadline_s: Optional[float] = None) -> bool:
        """Flip this gateway into DRAINING (idempotent; False when already
        draining). Admission of new chunks stops immediately (the control API
        503s POST /chunk_requests); a drain thread waits for every admitted
        chunk to finish — bounded by the deadline — then stops the daemon,
        whose shutdown path fsyncs the dedup journals and spills the segment
        memory tier so a replacement can adopt warm state."""
        with self._drain_lock:
            if self.draining.is_set():
                return False
            self.draining.set()
        from skyplane_tpu_torch.utils.envcfg import env_float
        from skyplane_tpu_torch.obs.events import EV_DRAIN_START
        from skyplane_tpu_torch.obs import get_recorder

        if deadline_s is None:
            deadline_s = env_float("SKYPLANE_TPU_DRAIN_DEADLINE_S", 30.0)
        self._drain_started_monotonic = time.monotonic()
        self._drain_reason = reason
        pending = self.api.incomplete_count()
        get_recorder().record(
            EV_DRAIN_START,
            gateway=self.gateway_id,
            region=self.region,
            reason=str(reason)[:200],
            deadline_s=float(deadline_s),
            pending_chunks=pending,
        )
        logger.fs.warning(
            f"[daemon {self.gateway_id}] DRAINING ({reason}): admission stopped, "
            f"{pending} chunk(s) to flush within {deadline_s:.0f}s"
        )
        self._drain_thread = threading.Thread(
            target=self._drain_run, args=(float(deadline_s),), name=f"drain-{self.gateway_id}", daemon=True
        )
        self._drain_thread.start()
        return True

    def _drain_run(self, deadline_s: float) -> None:
        """Wait (bounded) for the admitted chunk backlog to flush, then stop
        the daemon — run()'s shutdown path does the journal fsync + segment
        spill and records drain.complete AFTER they land."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not self.error_event.is_set():
            if self.api.incomplete_count() == 0:
                break
            time.sleep(0.05)
        self._drain_flushed_chunks = self.api.complete_count()
        remaining = self.api.incomplete_count()
        if remaining:
            logger.fs.warning(
                f"[daemon {self.gateway_id}] drain deadline hit with {remaining} chunk(s) unflushed; "
                "survivors pick them up through tracker failover"
            )
        self.stop()

    def _record_drain_complete(self) -> None:
        """Emitted from run()'s shutdown path, after journals/spill are
        durable — drain.complete must never precede the fsync it reports."""
        from skyplane_tpu_torch.obs.events import EV_DRAIN_COMPLETE
        from skyplane_tpu_torch.obs import get_recorder

        seconds = time.monotonic() - (self._drain_started_monotonic or time.monotonic())
        get_recorder().record(
            EV_DRAIN_COMPLETE,
            gateway=self.gateway_id,
            region=self.region,
            reason=self._drain_reason[:200],
            seconds=round(seconds, 3),
            flushed_chunks=self._drain_flushed_chunks,
            remaining_chunks=self.api.incomplete_count(),
            journals_flushed=len(self._dedup_indexes),
        )

    def _maybe_start_preempt_watcher(self) -> None:
        env_val = os.environ.get("SKYPLANE_TPU_PREEMPT_WATCH", "").strip().lower()
        from skyplane_tpu_torch.gateway.preempt import PreemptionWatcher, probe_for

        if self.preempt_watch is not None:
            if not self.preempt_watch:
                return
            # explicit kwarg (provisioned daemons / tests): probe by the
            # daemon's own cloud; local/unknown providers watch faults only
            provider = self.region.split(":")[0]
        else:
            if not env_val or env_val == "0":
                return
            # documented contract (docs/configuration.md): a provider NAME
            # selects the metadata probe; a bare "1"/"on"/"true" watches ONLY
            # the injected fault point — never the real metadata service
            provider = "" if env_val in ("1", "on", "true") else env_val
        self._preempt_watcher = PreemptionWatcher(
            lambda reason: self.begin_drain(reason=reason),
            probe=probe_for(provider),
            name=f"preempt-watcher-{self.gateway_id}",
        )
        self._preempt_watcher.start()

    # ---- run loop ----

    def run(self) -> None:
        self.api.start()
        for op in self.operators:
            op.start_workers()
        self._maybe_start_preempt_watcher()
        logger.fs.info(
            f"[daemon {self.gateway_id}] running: {len(self.operators)} operators, control port {self.api.port}"
        )
        try:
            while not self.api.shutdown_requested.is_set():
                self.api.pull_chunk_status_queue()
                if self.error_event.is_set():
                    while True:
                        try:
                            self.api.record_error(self.error_queue.get_nowait())
                        except queue.Empty:
                            break
                    logger.fs.error(f"[daemon {self.gateway_id}] stopping on operator error")
                    break
                time.sleep(0.05)
        finally:
            self.api.pull_chunk_status_queue()
            for op in self.operators:
                op.stop_workers(timeout=2.0)
            self.receiver.stop_all()
            self.fabric.close()
            # flush persistent dedup journals so the next daemon recovers a
            # clean (untorn) tail even after a prompt process exit
            for idx in self._dedup_indexes.values():
                try:
                    idx.close()
                except OSError as e:
                    logger.fs.warning(f"[daemon {self.gateway_id}] dedup journal close failed: {e}")
            # ... and spill the receiver's memory-tier segments to disk so
            # recovered sender indexes resolve across the restart instead of
            # NACK-storming their warm REFs
            if self.persist_dedup and self.receiver.segment_store is not None:
                try:
                    self.receiver.segment_store.flush_to_spill()
                except OSError as e:
                    logger.fs.warning(f"[daemon {self.gateway_id}] segment spill flush failed: {e}")
            # announced-preemption drain: the completion event is recorded
            # only HERE, after the journal close + spill flush above, so
            # drain.complete truthfully means "durable state handed off"
            if self.draining.is_set():
                self._record_drain_complete()
            if self._preempt_watcher is not None:
                self._preempt_watcher.stop(timeout=2.0)
            drain_thread = self._drain_thread
            if drain_thread is not None and drain_thread is not threading.current_thread():
                drain_thread.join(timeout=2.0)
            # keep the API up briefly so the client can collect errors/status
            time.sleep(0.2)
            # then actually release the control port: a subprocess daemon's
            # exit closes it anyway, but an IN-PROCESS daemon (tests, the
            # failover harness) would otherwise keep answering /status after
            # "death", making gateway-liveness detection unobservable
            self.api.stop()

    def stop(self) -> None:
        self.api.shutdown_requested.set()


def main(argv=None) -> None:
    # Pin the device BEFORE any kernel work. SKYPLANE_GATEWAY_DEVICE: "cuda"
    # (the default) runs on the current card, "cuda:N" makes card N current
    # first (so every bare "cuda" allocation and the kernels' builds land
    # there), "cpu" runs the kernels' plain versions even on a GPU machine.
    device = os.environ.get("SKYPLANE_GATEWAY_DEVICE", "cuda").strip() or "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)

    parser = argparse.ArgumentParser(description="skyplane_tpu_torch gateway daemon")
    parser.add_argument("--region", default=os.environ.get("SKYPLANE_REGION", "local:local"))
    parser.add_argument("--chunk-dir", default=os.environ.get("SKYPLANE_CHUNK_DIR", "/tmp/skyplane_tpu_torch/chunks"))
    parser.add_argument("--program-file", default=os.environ.get("GATEWAY_PROGRAM_FILE"))
    parser.add_argument("--info-file", default=os.environ.get("GATEWAY_INFO_FILE"))
    parser.add_argument("--gateway-id", default=os.environ.get("GATEWAY_ID", "gateway_0"))
    parser.add_argument("--control-port", type=int, default=int(os.environ.get("GATEWAY_CONTROL_PORT", "8081")))
    parser.add_argument("--bind-host", default="0.0.0.0")
    parser.add_argument("--e2ee-key-file", default=os.environ.get("E2EE_KEY_FILE"))
    parser.add_argument("--disable-tls", action="store_true")
    args = parser.parse_args(argv)

    program = json.loads(Path(args.program_file).read_text())
    info = json.loads(Path(args.info_file).read_text()) if args.info_file else {}
    e2ee_key = None
    if args.e2ee_key_file and Path(args.e2ee_key_file).exists():
        e2ee_key = Path(args.e2ee_key_file).read_bytes()
    daemon = GatewayDaemon(
        region=args.region,
        chunk_dir=args.chunk_dir,
        gateway_program=program,
        gateway_info=info,
        gateway_id=args.gateway_id,
        control_port=args.control_port,
        bind_host=args.bind_host,
        e2ee_key=e2ee_key,
        use_tls=not args.disable_tls,
        device=dev,
    )
    # graceful SIGTERM (provisioner teardown / docker stop): finish the status
    # pump and stop workers instead of dying mid-chunk. Installed here at the
    # process entrypoint — in-process embeddings use daemon.stop() instead.
    import signal

    signal.signal(signal.SIGTERM, lambda *_: daemon.stop())
    daemon.run()


if __name__ == "__main__":
    main()
