"""Deterministic fault injection + the knobs of the self-healing data plane.

``skyplane_tpu_torch.faults`` owns the chaos-engineering side of the robustness
story (docs/fault-injection.md): named fault points compiled into the hot
paths at near-zero disabled cost, armed by a seeded :class:`FaultPlan` so any
chaos run replays exactly, with firings exported as
``skyplane_faults_injected{point=...}`` metrics and trace spans. The recovery
machinery the faults exercise lives where the failures happen — the shared
:class:`~skyplane_tpu_torch.utils.retry.RetryPolicy`, the sender wire engine's
per-stream circuit breaker, per-chunk retry budgets, the receiver's NACK /
payload-error budgets, and the segment store's spill-failure degradation —
and ``scripts/soak_chaos.py`` proves them working *together* under injected
failure with byte-for-byte corpus integrity.
"""

from skyplane_tpu_torch.faults.injector import (
    FAULTS_ENV,
    NOOP_INJECTOR,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    configure_injector,
    decision_schedule,
    get_injector,
)

__all__ = [
    "FAULTS_ENV",
    "NOOP_INJECTOR",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "configure_injector",
    "decision_schedule",
    "get_injector",
]
