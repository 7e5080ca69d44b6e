"""Multi-tenant transfer service: admission, fair-share scheduling, and the
persistent cross-job dedup index.

The original architecture assumed one TransferJob per dataplane (SURVEY §2.3
Pipeline→Dataplane→TransferJob); serving heavy traffic from millions of users
means thousands of concurrent jobs sharing one gateway fleet (ROADMAP open
item 3). This package is the control layer that makes that sharing safe:

  * :mod:`skyplane_tpu_torch.tenancy.registry` — tenant/job registry and admission
    control. Tenant ids are minted at the API layer, ride on every
    :class:`~skyplane_tpu_torch.chunk.Chunk` and in the v5 wire header, and feed
    per-tenant accounting (labelled MetricsRegistry counters at
    ``GET /api/v1/metrics``, job admission at ``POST /api/v1/jobs``).
  * :mod:`skyplane_tpu_torch.tenancy.scheduler` — a weighted fair-share scheduler
    arbitrating the scarce gateway resources (sender in-flight/frame-ahead
    bytes, chunk slots covering DeviceBatchRunner occupancy) via per-tenant
    token accounting with hard quotas, so a hostile tenant's NACK storm or
    giant corpus degrades only its own throughput.
  * :mod:`skyplane_tpu_torch.tenancy.persistent_index` — the sender fingerprint
    index promoted to a persistent cross-job asset: append-only on-disk
    journal + snapshot with crash-safe recovery, per-tenant byte attribution
    and quotas, globally-ordered eviction preserved. Repeated corpora
    (checkpoints, snapshots) hit warm fingerprints across jobs and daemon
    restarts.

See docs/multitenancy.md for the admission model, quota knobs, and the
persistent-index layout/recovery semantics.
"""

from skyplane_tpu_torch.chunk import DEFAULT_TENANT_ID, validate_tenant_id
from skyplane_tpu_torch.tenancy.persistent_index import PersistentDedupIndex
from skyplane_tpu_torch.tenancy.registry import AdmissionError, TenantRegistry, mint_tenant_id
from skyplane_tpu_torch.tenancy.scheduler import (
    RES_CHUNK_SLOTS,
    RES_WIRE_BYTES,
    FairShareScheduler,
    SchedulerTimeout,
)

__all__ = [
    "AdmissionError",
    "DEFAULT_TENANT_ID",
    "FairShareScheduler",
    "PersistentDedupIndex",
    "RES_CHUNK_SLOTS",
    "RES_WIRE_BYTES",
    "SchedulerTimeout",
    "TenantRegistry",
    "mint_tenant_id",
    "validate_tenant_id",
]
