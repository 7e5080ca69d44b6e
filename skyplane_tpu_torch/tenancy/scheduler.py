"""Weighted fair-share scheduler for the gateway's scarce resources.

One gateway serves many concurrent TransferJobs; without arbitration the
first tenant to saturate the sender pipeline (or the one whose NACK storm
keeps re-queueing chunks) owns every connection slot, frame-ahead buffer
byte, and DeviceBatchRunner window. The scheduler is a token accountant:
every unit of a scarce resource a tenant holds is acquired before use and
released when the work resolves (ack / requeue / failure), and grants obey
weighted max-min fairness with optional hard quotas.

Grant rule for ``acquire(tenant, resource, amount)``:

  1. **hard quota** — if the tenant has a cap on this resource,
     ``usage + amount`` must stay under it. A capped tenant waits on its OWN
     releases; nobody else is affected (isolation).
  2. **capacity** — ``amount`` must fit in free capacity. An oversized
     request is granted to a sole user of an idle resource (mirrors the wire
     engine's "an empty window always admits one frame" rule) so one giant
     chunk can never wedge a stream.
  3. **fair share** — under contention (another tenant is waiting), a tenant
     may not exceed its weighted entitlement
     ``capacity * weight / sum(active weights)``. With nobody waiting the
     scheduler is work-conserving: free capacity goes to whoever asks.

Everything is one condition variable per resource: releases notify waiters,
waits tick at 0.2 s so abort checks (daemon shutdown) are never missed.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from skyplane_tpu_torch.chunk import DEFAULT_TENANT_ID
from skyplane_tpu_torch.exceptions import SkyplaneTpuException
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.obs import lockwitness as lockcheck

#: canonical resource names (docs/multitenancy.md). wire_bytes bounds the
#: bytes a tenant may hold in sender frame-ahead queues + in-flight windows;
#: chunk_slots bounds concurrently-processed chunks (and thereby the share of
#: DeviceBatchRunner batch slots a tenant's framers can occupy).
RES_WIRE_BYTES = "wire_bytes"
RES_CHUNK_SLOTS = "chunk_slots"

_IDLE_TICK_S = 0.2


class SchedulerTimeout(SkyplaneTpuException):
    """acquire() gave up waiting for tokens (quota exhausted / starved)."""


class _Resource:
    __slots__ = ("name", "capacity", "cond", "usage", "waiting", "used_total")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = int(capacity)
        self.cond = threading.Condition(lockcheck.wrap(threading.RLock(), "_Resource.cond"))
        self.usage: Dict[str, int] = {}  # tenant -> held tokens
        self.waiting: Dict[str, int] = {}  # tenant -> waiter count
        self.used_total = 0


class FairShareScheduler:
    def __init__(self):
        self._resources: Dict[str, _Resource] = {}
        self._weights: Dict[str, float] = {}
        self._caps: Dict[str, Dict[str, int]] = {}  # tenant -> resource -> hard cap
        self._meta_lock = lockcheck.wrap(threading.Lock(), "FairShareScheduler._meta_lock")
        # accounting (read by the tenant metrics provider): shared across
        # resources, so read-modify-writes serialize on _meta_lock
        self._grants: Dict[str, int] = {}
        self._throttle_waits: Dict[str, int] = {}
        self._throttle_wait_ns: Dict[str, int] = {}
        self._timeouts: Dict[str, int] = {}

    # ---- configuration ----

    def configure_resource(self, name: str, capacity: int) -> None:
        """Create or re-bound a resource pool (idempotent)."""
        with self._meta_lock:
            res = self._resources.get(name)
            if res is None:
                self._resources[name] = _Resource(name, capacity)
                return
        with res.cond:
            res.capacity = int(capacity)
            res.cond.notify_all()

    def set_tenant(self, tenant: str, weight: float = 1.0, caps: Optional[Dict[str, int]] = None) -> None:
        """Set a tenant's fair-share weight and optional per-resource hard
        quotas (absolute token caps). Re-applying updates in place."""
        with self._meta_lock:
            self._weights[tenant] = max(0.001, float(weight))
            if caps is not None:
                self._caps[tenant] = {k: int(v) for k, v in caps.items()}
        for res in list(self._resources.values()):
            with res.cond:
                res.cond.notify_all()  # a raised quota may unblock waiters

    def _resource(self, name: str) -> _Resource:
        with self._meta_lock:
            res = self._resources.get(name)
            if res is None:
                raise SkyplaneTpuException(f"unknown scheduler resource {name!r}")
            return res

    # ---- token accounting ----

    def acquire(
        self,
        tenant: str,
        resource: str,
        amount: int,
        timeout: Optional[float] = None,
        abort_check: Optional[Callable[[], bool]] = None,
    ) -> bool:
        """Block until ``amount`` tokens are grantable under the fairness
        rule. Returns True on grant, False when ``abort_check`` fired; raises
        :class:`SchedulerTimeout` when ``timeout`` expires first."""
        tenant = tenant or DEFAULT_TENANT_ID
        amount = max(0, int(amount))
        res = self._resource(resource)
        deadline = time.monotonic() + timeout if timeout is not None else None
        waited = False
        t0 = 0
        with res.cond:
            while True:
                if self._grantable_locked(res, tenant, amount):
                    res.usage[tenant] = res.usage.get(tenant, 0) + amount
                    res.used_total += amount
                    # counter dicts are shared across resources: their
                    # read-modify-writes serialize on _meta_lock (cond ->
                    # meta nesting, same order _grantable_locked uses)
                    with self._meta_lock:
                        self._grants[tenant] = self._grants.get(tenant, 0) + 1
                    if waited:
                        res.waiting[tenant] -= 1
                        if res.waiting[tenant] <= 0:
                            del res.waiting[tenant]
                        with self._meta_lock:
                            self._throttle_wait_ns[tenant] = (
                                self._throttle_wait_ns.get(tenant, 0) + time.perf_counter_ns() - t0
                            )
                    return True
                if not waited:
                    waited = True
                    t0 = time.perf_counter_ns()
                    res.waiting[tenant] = res.waiting.get(tenant, 0) + 1
                    with self._meta_lock:
                        self._throttle_waits[tenant] = self._throttle_waits.get(tenant, 0) + 1
                if abort_check is not None and abort_check():
                    self._unwait_locked(res, tenant, t0)
                    return False
                remaining = _IDLE_TICK_S
                if deadline is not None:
                    remaining = min(remaining, deadline - time.monotonic())
                    if remaining <= 0:
                        self._unwait_locked(res, tenant, t0)
                        with self._meta_lock:
                            self._timeouts[tenant] = self._timeouts.get(tenant, 0) + 1
                        raise SchedulerTimeout(
                            f"tenant {tenant} timed out waiting for {amount} {resource} tokens "
                            f"(held {res.usage.get(tenant, 0)}, capacity {res.capacity})"
                        )
                res.cond.wait(remaining)

    def _unwait_locked(self, res: _Resource, tenant: str, t0: int) -> None:
        res.waiting[tenant] = res.waiting.get(tenant, 1) - 1
        if res.waiting[tenant] <= 0:
            res.waiting.pop(tenant, None)
        with self._meta_lock:
            self._throttle_wait_ns[tenant] = self._throttle_wait_ns.get(tenant, 0) + time.perf_counter_ns() - t0

    def _grantable_locked(self, res: _Resource, tenant: str, amount: int) -> bool:
        held = res.usage.get(tenant, 0)
        with self._meta_lock:
            cap = self._caps.get(tenant, {}).get(res.name)
            weights = dict(self._weights)
        if cap is not None and held + amount > cap:
            return False  # hard quota: this tenant waits on its own releases
        free = res.capacity - res.used_total
        if amount > free:
            # idle-resource escape hatch: a sole requester with nothing held
            # may exceed capacity (one oversized chunk must not wedge forever)
            return res.used_total == 0 and held == 0
        others_waiting = any(t != tenant and n > 0 for t, n in res.waiting.items())
        if not others_waiting:
            return True  # work-conserving: free tokens go to whoever asks
        if held == 0:
            # progress floor: a tenant holding NOTHING always gets its first
            # grant when it fits free capacity, even past its entitlement.
            # Without this, N waiters each wanting more than capacity/N (or
            # more tenants than chunk slots) would all fail the entitlement
            # check forever while the resource sits idle — a fairness rule
            # must never deadlock the pool it arbitrates.
            return True
        active = {t for t, u in res.usage.items() if u > 0} | set(res.waiting) | {tenant}
        total_w = sum(weights.get(t, 1.0) for t in active)
        entitlement = res.capacity * weights.get(tenant, 1.0) / total_w if total_w else res.capacity
        return held + amount <= entitlement

    def release(self, tenant: str, resource: str, amount: int) -> None:
        inj = get_injector()
        if inj.enabled:
            # token-release fault (docs/fault-injection.md): raised BEFORE any
            # usage mutation, so the caller's retry (SCHED_RELEASE_POLICY in
            # the sender operator) re-runs release idempotently — a skipped
            # release would leak the tenant's tokens until job teardown
            inj.check("sched.release", SkyplaneTpuException, "injected scheduler release failure")
        tenant = tenant or DEFAULT_TENANT_ID
        amount = max(0, int(amount))
        res = self._resource(resource)
        with res.cond:
            held = res.usage.get(tenant, 0)
            take = min(held, amount)  # defensive: never go negative
            if take:
                res.usage[tenant] = held - take
                if res.usage[tenant] <= 0:
                    del res.usage[tenant]
                res.used_total -= take
            res.cond.notify_all()

    # ---- introspection ----

    def usage_snapshot(self) -> Dict[str, Dict[str, int]]:
        """{resource: {tenant: held tokens}} — served at /api/v1/tenants."""
        out: Dict[str, Dict[str, int]] = {}
        with self._meta_lock:
            resources = list(self._resources.values())
        for res in resources:
            with res.cond:
                out[res.name] = dict(res.usage)
        return out

    def tenant_counters(self) -> Dict[str, Dict[str, float]]:
        """Per-metric {tenant: value} maps for the labelled metrics provider
        (rendered as ``skyplane_tenant_<metric>{tenant="..."}``)."""
        with self._meta_lock:
            out: Dict[str, Dict[str, float]] = {
                "sched_grants": dict(self._grants),
                "sched_throttle_waits": dict(self._throttle_waits),
                "sched_throttle_wait_ns": dict(self._throttle_wait_ns),
                "sched_timeouts": dict(self._timeouts),
            }
        held: Dict[str, float] = {}
        for res_name, usage in self.usage_snapshot().items():
            for tenant, n in usage.items():
                held[tenant] = held.get(tenant, 0) + n
            out[f"sched_held_{res_name}"] = {t: float(v) for t, v in usage.items()}
        out["sched_held_total"] = held
        return out
