"""Tenant/job registry and admission control.

Admission is the front door of the multi-tenant gateway: a client registers
each TransferJob (``POST /api/v1/jobs``) before dispatching its chunks, and
the registry enforces the concurrency envelope — a global job cap (the
gateway's memory/thread budget is finite) and a per-tenant job cap (one
tenant's job storm must not consume the whole envelope). Rejections carry
:class:`AdmissionError` and surface as HTTP 429.

Accounting: every registered chunk is attributed to its tenant (chunks,
bytes), as are sender deliveries and receiver decodes; the aggregate feeds
the labelled ``skyplane_tenant_*`` metric families on ``/api/v1/metrics``
and the human-readable ``GET /api/v1/tenants`` snapshot.

Registration also pushes each tenant's weight and hard quotas into the
:class:`~skyplane_tpu_torch.tenancy.scheduler.FairShareScheduler`, so admission is
where fairness policy enters the data plane.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional

from skyplane_tpu_torch.chunk import validate_tenant_id
from skyplane_tpu_torch.exceptions import SkyplaneTpuException
from skyplane_tpu_torch.tenancy.scheduler import FairShareScheduler
from skyplane_tpu_torch.obs import lockwitness as lockcheck


def mint_tenant_id() -> str:
    """Mint a fresh 64-bit tenant tag (16 lowercase hex chars). Called at the
    API layer (SkyplaneClient) when the caller did not bring one."""
    return uuid.uuid4().hex[:16]


class AdmissionError(SkyplaneTpuException):
    """Job rejected at admission (caps exhausted) — HTTP 429 on the API."""


@dataclass
class _TenantState:
    tenant_id: str
    weight: float = 1.0
    active_jobs: int = 0
    jobs_admitted: int = 0
    jobs_rejected: int = 0
    chunks_registered: int = 0
    bytes_registered: int = 0
    chunks_delivered: int = 0
    bytes_delivered: int = 0
    decode_raw_bytes: int = 0
    nacks: int = 0
    quotas: Dict[str, int] = field(default_factory=dict)


class TenantRegistry:
    #: a job whose client died without DELETE is swept after this long, so
    #: leaked admissions cannot permanently brick a tenant (or the gateway)
    #: with 429s. Generous: a legitimate transfer holding its slot for days
    #: is re-admittable (admission is idempotent per job_id).
    JOB_TTL_S = 24 * 3600.0
    #: bound on distinct tenants tracked (accounting + metric label
    #: cardinality): every wire frame carries an attacker-choosable 64-bit
    #: tag, and unbounded per-tenant state is exactly the bug class the
    #: unbounded-queue-in-gateway lint rule exists for. Past the cap, the
    #: oldest IDLE tenant's accounting is evicted (its history resets).
    MAX_TENANTS = 4096

    def __init__(
        self,
        scheduler: Optional[FairShareScheduler] = None,
        max_jobs_total: int = 1024,
        max_jobs_per_tenant: int = 64,
        job_ttl_s: Optional[float] = None,
    ):
        self.scheduler = scheduler
        self.max_jobs_total = int(max_jobs_total)
        self.max_jobs_per_tenant = int(max_jobs_per_tenant)
        self.job_ttl_s = float(job_ttl_s) if job_ttl_s is not None else self.JOB_TTL_S
        self._lock = lockcheck.wrap(threading.Lock(), "TenantRegistry._lock")
        self._tenants: Dict[str, _TenantState] = {}
        self._jobs: Dict[str, str] = {}  # job_id -> tenant_id
        self._job_started: Dict[str, float] = {}

    # ---- tenants ----

    def _tenant_locked(self, tenant_id: str) -> _TenantState:
        state = self._tenants.get(tenant_id)
        if state is None:
            if len(self._tenants) >= self.MAX_TENANTS:
                victim = next((t for t, s in self._tenants.items() if s.active_jobs == 0), None)
                if victim is not None:
                    del self._tenants[victim]  # oldest idle tenant's accounting resets
            state = self._tenants[tenant_id] = _TenantState(tenant_id=tenant_id)
        return state

    def _expire_stale_jobs_locked(self, now: float) -> None:
        """Sweep admissions whose client never released them (crashed before
        finalize/abort): past the TTL the slot returns to the pool."""
        stale = [j for j, t0 in self._job_started.items() if now - t0 > self.job_ttl_s]
        for job_id in stale:
            tenant_id = self._jobs.pop(job_id, None)
            self._job_started.pop(job_id, None)
            state = self._tenants.get(tenant_id) if tenant_id else None
            if state is not None:
                state.active_jobs = max(0, state.active_jobs - 1)

    def register_tenant(
        self, tenant_id: Optional[str], weight: float = 1.0, quotas: Optional[Dict[str, int]] = None
    ) -> str:
        """Create/update a tenant (idempotent upsert); pushes weight and hard
        quotas into the fair-share scheduler. Returns the canonical id."""
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            state = self._tenant_locked(tenant_id)
            state.weight = max(0.001, float(weight))
            if quotas:
                state.quotas.update({k: int(v) for k, v in quotas.items()})
            weight, caps = state.weight, dict(state.quotas)
        if self.scheduler is not None:
            self.scheduler.set_tenant(tenant_id, weight=weight, caps=caps)
        return tenant_id

    # ---- admission ----

    def admit_job(
        self,
        tenant_id: Optional[str],
        job_id: str,
        weight: Optional[float] = None,
        quotas: Optional[Dict[str, int]] = None,
    ) -> str:
        """Admit one job under the concurrency envelope, auto-registering the
        tenant. Idempotent per job_id. Raises :class:`AdmissionError` when a
        cap is exhausted (the caller maps this to HTTP 429)."""
        tenant_id = validate_tenant_id(tenant_id)
        if weight is not None or quotas is not None:
            self.register_tenant(tenant_id, weight=weight if weight is not None else 1.0, quotas=quotas)
        with self._lock:
            self._expire_stale_jobs_locked(time.time())
            if self._jobs.get(job_id) == tenant_id:
                # idempotent re-admit (client retry / service-mode heartbeat):
                # the re-admit IS the liveness signal, so it must refresh the
                # TTL clock — without this, a continuous-sync job that
                # heartbeats every few seconds still got reaped at the 24 h
                # mark because only the ORIGINAL admission time was kept
                # (the reap-vs-heartbeat race, docs/service-mode.md)
                self._job_started[job_id] = time.time()
                return tenant_id
            state = self._tenant_locked(tenant_id)
            if len(self._jobs) >= self.max_jobs_total:
                state.jobs_rejected += 1
                raise AdmissionError(
                    f"gateway at its global job cap ({self.max_jobs_total} active); retry later"
                )
            if state.active_jobs >= self.max_jobs_per_tenant:
                state.jobs_rejected += 1
                raise AdmissionError(
                    f"tenant {tenant_id} at its job cap ({self.max_jobs_per_tenant} active)"
                )
            self._jobs[job_id] = tenant_id
            self._job_started[job_id] = time.time()
            state.active_jobs += 1
            state.jobs_admitted += 1
            job_weight, job_caps = state.weight, dict(state.quotas)
        if self.scheduler is not None:
            # the scheduler must know this tenant's weight even when the admit
            # carried no explicit policy (default weight 1.0)
            self.scheduler.set_tenant(tenant_id, weight=job_weight, caps=job_caps)
        return tenant_id

    def heartbeat_job(self, job_id: str) -> bool:
        """Refresh a live job's TTL clock without the admission side effects
        (no scheduler push, no tenant upsert). Returns False for an unknown
        job — the caller should re-admit, not assume liveness: a sweep that
        already reaped the slot must not be silently un-reaped."""
        with self._lock:
            if job_id not in self._jobs:
                return False
            self._job_started[job_id] = time.time()
            return True

    def finish_job(self, job_id: str) -> bool:
        """Release a job's admission slot (idempotent)."""
        with self._lock:
            tenant_id = self._jobs.pop(job_id, None)
            self._job_started.pop(job_id, None)
            if tenant_id is None:
                return False
            state = self._tenants.get(tenant_id)
            if state is not None:
                state.active_jobs = max(0, state.active_jobs - 1)
            return True

    def job_tenant(self, job_id: str) -> Optional[str]:
        with self._lock:
            return self._jobs.get(job_id)

    def has_active_job(self, tenant_id: Optional[str]) -> bool:
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            state = self._tenants.get(tenant_id)
            return state is not None and state.active_jobs > 0

    # ---- accounting (bumped from the data plane) ----

    def note_chunks_registered(self, tenant_id: Optional[str], n_chunks: int, n_bytes: int) -> None:
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            state = self._tenant_locked(tenant_id)
            state.chunks_registered += n_chunks
            state.bytes_registered += n_bytes

    def note_delivered(self, tenant_id: Optional[str], n_bytes: int) -> None:
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            state = self._tenant_locked(tenant_id)
            state.chunks_delivered += 1
            state.bytes_delivered += n_bytes

    def note_decoded(self, tenant_id: Optional[str], raw_bytes: int) -> None:
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            self._tenant_locked(tenant_id).decode_raw_bytes += raw_bytes

    def note_nack(self, tenant_id: Optional[str]) -> None:
        tenant_id = validate_tenant_id(tenant_id)
        with self._lock:
            self._tenant_locked(tenant_id).nacks += 1

    # ---- introspection ----

    def snapshot(self) -> dict:
        """GET /api/v1/tenants payload: tenants, active jobs, accounting."""
        with self._lock:
            tenants = {
                t: {
                    "weight": s.weight,
                    "active_jobs": s.active_jobs,
                    "jobs_admitted": s.jobs_admitted,
                    "jobs_rejected": s.jobs_rejected,
                    "chunks_registered": s.chunks_registered,
                    "bytes_registered": s.bytes_registered,
                    "chunks_delivered": s.chunks_delivered,
                    "bytes_delivered": s.bytes_delivered,
                    "decode_raw_bytes": s.decode_raw_bytes,
                    "nacks": s.nacks,
                    "quotas": dict(s.quotas),
                }
                for t, s in self._tenants.items()
            }
            jobs = {
                j: {"tenant_id": t, "started_at": self._job_started.get(j)} for j, t in self._jobs.items()
            }
        out = {
            "tenants": tenants,
            "jobs": jobs,
            "max_jobs_total": self.max_jobs_total,
            "max_jobs_per_tenant": self.max_jobs_per_tenant,
        }
        if self.scheduler is not None:
            out["scheduler_usage"] = self.scheduler.usage_snapshot()
        return out

    def tenant_counters(self) -> Dict[str, Dict[str, float]]:
        """Per-metric {tenant: value} maps for the labelled metrics provider."""
        with self._lock:
            metrics = (
                "active_jobs",
                "jobs_admitted",
                "jobs_rejected",
                "chunks_registered",
                "bytes_registered",
                "chunks_delivered",
                "bytes_delivered",
                "decode_raw_bytes",
                "nacks",
            )
            return {m: {t: float(getattr(s, m)) for t, s in self._tenants.items()} for m in metrics}
