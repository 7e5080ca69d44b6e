"""Fleet-wide content-addressed dedup fabric (docs/dedup-fabric.md).

PR 6 made dedup warmth durable per daemon; PR 13's pump sharded it into
per-worker partitions — so every core and every gateway added *fragments*
fingerprint warmth and raises the cross-shard NACK -> literal-resend rate.
This package turns N fragmented caches into one compounding fleet cache:

  * :mod:`ring` — a consistent-hash ring mapping fingerprint -> owning
    gateway, stable under join/leave/drain (virtual nodes; replacements
    adopt their dead predecessor's seat).
  * :mod:`fabric` — :class:`DedupFabric`: peer fetch on receiver-side REF
    miss (``GET /api/v1/segment/<fp>``), write-through placement pushes,
    and the gossiped fingerprint-summary exchange that lets every sender
    partition treat "any fleet member proved this fp" as durable warmth.
  * :mod:`exchange` — the summary-exchange round piggybacked on the PR-14
    service's sync loop (usable standalone by tests and soaks).

Peer fetch is strictly an optimization rung: every failure mode degrades to
the existing NACK -> literal-resend contract, never to a new one.
"""

from skyplane_tpu_torch.dedup_fabric.ring import ConsistentHashRing
from skyplane_tpu_torch.dedup_fabric.fabric import (
    FABRIC_ENV,
    FABRIC_COUNTER_ZERO,
    DedupFabric,
    fabric_from_env,
)
from skyplane_tpu_torch.dedup_fabric.exchange import run_summary_exchange

__all__ = [
    "ConsistentHashRing",
    "DedupFabric",
    "FABRIC_ENV",
    "FABRIC_COUNTER_ZERO",
    "fabric_from_env",
    "run_summary_exchange",
]
