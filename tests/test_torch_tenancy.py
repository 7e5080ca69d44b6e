"""The port's tenancy layer (``skyplane_tpu_torch/tenancy/``) against the JAX
package's: the fair-share scheduler's grants and the registry's admissions on
the same seeded operation sequences, and the persistent dedup index's journal
and snapshot files, byte for byte, each package recovering the other's.
"""

from __future__ import annotations

import numpy as np
import pytest

from skyplane_tpu import tenancy as ref_tenancy
from skyplane_tpu.faults import FaultPlan as RefFaultPlan
from skyplane_tpu.faults import configure_injector as ref_configure_injector
from skyplane_tpu_torch import tenancy as port_tenancy
from skyplane_tpu_torch.faults import FaultPlan, configure_injector

PKGS = {"port": port_tenancy, "ref": ref_tenancy}
TENANTS = ["a1" * 8, "b2" * 8, "c3" * 8, "0" * 16]


def _scheduler_trace(mod, seed: int):
    """Outcomes of a seeded single-threaded sequence of weight/cap updates,
    acquires (timeout 0: grant or SchedulerTimeout) and releases."""
    rng = np.random.default_rng(seed)
    sched = mod.FairShareScheduler()
    sched.configure_resource(mod.RES_WIRE_BYTES, 1000)
    sched.configure_resource(mod.RES_CHUNK_SLOTS, 8)
    held = []
    out = []
    for _ in range(400):
        op = rng.integers(0, 10)
        tenant = TENANTS[rng.integers(0, len(TENANTS))]
        res = (mod.RES_WIRE_BYTES, mod.RES_CHUNK_SLOTS)[rng.integers(0, 2)]
        if op == 0:
            caps = {res: int(rng.integers(1, 900))} if rng.integers(0, 2) else None
            sched.set_tenant(tenant, weight=float(rng.integers(1, 5)), caps=caps)
            out.append(("set", tenant))
        elif op < 6 or not held:
            amount = int(rng.integers(1, 400 if res == mod.RES_WIRE_BYTES else 4))
            try:
                out.append(("acquire", tenant, res, amount, sched.acquire(tenant, res, amount, timeout=0.0)))
                held.append((tenant, res, amount))
            except mod.SchedulerTimeout:
                out.append(("timeout", tenant, res, amount))
        else:
            tenant, res, amount = held.pop(int(rng.integers(0, len(held))))
            sched.release(tenant, res, amount)
            out.append(("release", tenant, res, amount))
        out.append(sched.usage_snapshot())
    counters = sched.tenant_counters()
    counters.pop("sched_throttle_wait_ns")  # wall time
    return out, counters


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_grants_equal_the_jax_package(seed):
    assert _scheduler_trace(port_tenancy, seed) == _scheduler_trace(ref_tenancy, seed)


def _registry_trace(mod, seed: int):
    rng = np.random.default_rng(seed)
    sched = mod.FairShareScheduler()
    sched.configure_resource(mod.RES_WIRE_BYTES, 1 << 20)
    reg = mod.TenantRegistry(scheduler=sched, max_jobs_total=9, max_jobs_per_tenant=3)
    out = []
    for i in range(300):
        op = rng.integers(0, 8)
        tenant = TENANTS[rng.integers(0, len(TENANTS))]
        job = f"job-{rng.integers(0, 20)}"
        if op < 4:
            quotas = {"wire_bytes": int(rng.integers(1, 1 << 16))} if rng.integers(0, 3) == 0 else None
            try:
                out.append(("admit", job, reg.admit_job(tenant, job, quotas=quotas)))
            except mod.AdmissionError as e:
                out.append(("rejected", job, str(e)))
        elif op == 4:
            out.append(("finish", job, reg.finish_job(job)))
        elif op == 5:
            out.append(("heartbeat", job, reg.heartbeat_job(job)))
        elif op == 6:
            reg.note_chunks_registered(tenant, int(rng.integers(1, 5)), int(rng.integers(1, 1 << 20)))
            reg.note_delivered(tenant, int(rng.integers(1, 1 << 20)))
        else:
            reg.note_nack(tenant)
            out.append(("active", tenant, reg.has_active_job(tenant)))
    snap = reg.snapshot()
    for job in snap["jobs"].values():
        job.pop("started_at")  # wall time
    return out, snap, reg.tenant_counters(), sched.tenant_counters()["sched_grants"]


@pytest.mark.parametrize("seed", [3, 4])
def test_registry_admissions_equal_the_jax_package(seed):
    assert _registry_trace(port_tenancy, seed) == _registry_trace(ref_tenancy, seed)


def _index_ops(idx, seed: int):
    """A seeded run of adds (tenants, quotas), discards and a compaction."""
    rng = np.random.default_rng(seed)
    fps = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(120)]
    idx.set_tenant_quota(TENANTS[1], 40_000)
    for i in range(400):
        fp = fps[rng.integers(0, len(fps))]
        if rng.integers(0, 5) == 0:
            idx.discard(fp)
        else:
            idx.add(fp, int(rng.integers(100, 4000)), tenant=TENANTS[rng.integers(0, 3)])
        if i == 250:
            idx.compact()


def _index_state(idx):
    c = idx.counters()
    return (
        sorted(idx._owner.items()),
        {t: idx.tenant_bytes(t) for t in TENANTS},
        {k: c[k] for k in ("index_entries", "index_bytes", "index_recovered_entries", "tenant_index_bytes")},
    )


@pytest.mark.parametrize("seed", [5, 6])
def test_persistent_index_files_equal_the_jax_package(tmp_path, seed):
    """Journal and snapshot bytes are equal after the same operations, and
    each package recovers the other's files to the same state."""
    for pkg, mod in PKGS.items():
        idx = mod.PersistentDedupIndex(tmp_path / pkg, max_bytes=300_000, journal_max_bytes=1 << 16)
        _index_ops(idx, seed)
        idx.close()
    for name in ("index.journal", "index.snap"):
        port_bytes = (tmp_path / "port" / name).read_bytes()
        assert port_bytes == (tmp_path / "ref" / name).read_bytes(), name
        assert len(port_bytes) > 0, name
    states = {}
    for reader, mod in PKGS.items():
        for writer in PKGS:
            idx = mod.PersistentDedupIndex(tmp_path / writer, max_bytes=300_000, journal_max_bytes=1 << 16)
            states[reader, writer] = _index_state(idx)
            idx.close()
    assert len(set(map(repr, states.values()))) == 1, "recovered states differ"
    assert states["port", "ref"][0], "nothing was recovered"


def test_torn_tail_is_dropped_by_both_packages(tmp_path):
    """A half record at the journal's tail (a crash mid-append): both packages
    drop it, truncate the journal to the same bytes and recover equal state."""
    for pkg, mod in PKGS.items():
        idx = mod.PersistentDedupIndex(tmp_path / pkg, journal_max_bytes=1 << 20)
        _index_ops(idx, 7)
        idx.close()
        with open(tmp_path / pkg / "index.journal", "ab") as f:
            f.write(b"\x01" + b"\x55" * 20)
    states = {}
    for pkg, mod in PKGS.items():
        idx = mod.PersistentDedupIndex(tmp_path / pkg, journal_max_bytes=1 << 20)
        states[pkg] = (_index_state(idx), idx.counters()["index_torn_entries_dropped"])
        idx.close()
    assert states["port"] == states["ref"]
    assert states["port"][1] == 1
    assert (tmp_path / "port" / "index.journal").read_bytes() == (tmp_path / "ref" / "index.journal").read_bytes()


def test_injected_torn_write_is_recovered_alike(tmp_path):
    """The ``index.journal_torn`` fault point tears the same record in both
    packages; recovery of either package's journal gives the same state."""
    plan = {"seed": 11, "points": {"index.journal_torn": {"p": 0.02}}}
    injectors = {"port": (FaultPlan, configure_injector), "ref": (RefFaultPlan, ref_configure_injector)}
    for pkg, mod in PKGS.items():
        plan_cls, configure = injectors[pkg]
        configure(plan_cls.from_dict(plan))
        try:
            idx = mod.PersistentDedupIndex(tmp_path / pkg, journal_max_bytes=1 << 20)
            _index_ops(idx, 8)
            idx.close()
        finally:
            configure(None)
    journal = (tmp_path / "port" / "index.journal").read_bytes()
    assert journal == (tmp_path / "ref" / "index.journal").read_bytes()
    assert len(journal) % 37, "the fault never tore a record (records are 37 bytes)"
    states = {}
    for reader, mod in PKGS.items():
        for writer in PKGS:
            idx = mod.PersistentDedupIndex(tmp_path / writer, journal_max_bytes=1 << 20)
            states[reader, writer] = _index_state(idx)
            idx.close()
    assert len(set(map(repr, states.values()))) == 1
