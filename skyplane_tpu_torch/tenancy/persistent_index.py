"""Persistent cross-job sender dedup index: journal + snapshot + per-tenant
byte attribution.

``SenderDedupIndex`` (ops/dedup.py) is an in-memory LRU that dies with the
operator, so every new job — and every daemon restart — starts cold and
resends literals the destination already holds. This subclass promotes the
index to a fleet-level asset:

  * **append-only journal** (``index.journal``): every committed fingerprint
    (``add`` after an ACK) and every rollback (``discard`` after a NACK) is
    one fixed-size CRC-protected record. Appends are buffered+flushed, never
    fsynced — a killed process loses at most the OS write-back window, and a
    torn tail is detected and dropped at recovery, never replayed.
  * **snapshot compaction** (``index.snap``): when the journal outgrows its
    bound, the live entries are written (in global LRU order, so recovery
    preserves eviction order) to a temp file and atomically ``os.replace``d
    over the snapshot — the PR-3 atomic-landing idiom — then the journal is
    truncated. A crash between the two leaves a snapshot plus a journal whose
    replay is idempotent.
  * **per-tenant attribution + quotas**: every entry is owned by the tenant
    that shipped its literal. A tenant over its index-byte quota evicts its
    OWN oldest entries to make room — a giant-corpus tenant can only churn
    its own warm set, never a neighbor's. Global capacity eviction stays
    exactly the base class's globally-ordered (min-seq) policy.

Safety: a recovered fingerprint may be stale (the receiver restarted without
its segments). That is the NACK contract's job — an unresolvable REF nacks,
the sender discards those fps (journaled) and resends literals — so a warm
index is a throughput optimization, never a correctness risk. Pair with
``SegmentStore(persistent_spill=True)`` on the receiver so warm REFs
actually resolve across restarts.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

from skyplane_tpu_torch.chunk import DEFAULT_TENANT_ID
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.ops.dedup import SenderDedupIndex
from skyplane_tpu_torch.utils.fsio import fsync_replace
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.obs import lockwitness as lockcheck

_REC = struct.Struct("<B16sQ8s")  # kind, fp, size, tenant8 (+ crc32 suffix)
_REC_LEN = _REC.size + 4
_KIND_ADD = 1
_KIND_DISCARD = 2
_SNAP_MAGIC = b"SKDI\x01"


def _pack_record(kind: int, fp: bytes, size: int, tenant: str) -> bytes:
    body = _REC.pack(kind, fp, size, bytes.fromhex(tenant))
    return body + struct.pack("<I", zlib.crc32(body))


def _unpack_record(buf: bytes, off: int) -> Optional[Tuple[int, bytes, int, str]]:
    """One record at ``off``; None when truncated/torn (CRC mismatch)."""
    if off + _REC_LEN > len(buf):
        return None
    body = buf[off : off + _REC.size]
    (crc,) = struct.unpack_from("<I", buf, off + _REC.size)
    if zlib.crc32(body) != crc:
        return None
    kind, fp, size, tenant8 = _REC.unpack(body)
    if kind not in (_KIND_ADD, _KIND_DISCARD):
        return None
    return kind, fp, size, tenant8.hex()


class PersistentDedupIndex(SenderDedupIndex):
    def __init__(
        self,
        state_dir,
        max_bytes: int = 16 << 30,
        stripes: int = 16,
        journal_max_bytes: int = 8 << 20,
        default_tenant_quota_bytes: Optional[int] = None,
    ):
        super().__init__(max_bytes=max_bytes, stripes=stripes)
        self._dir = Path(state_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._snap_path = self._dir / "index.snap"
        self._journal_path = self._dir / "index.journal"
        self._journal_max_bytes = max(1 << 16, int(journal_max_bytes))
        # attribution state, all guarded by _attr_lock (never held across the
        # base class's stripe locks — add/discard touch them sequentially)
        self._attr_lock = lockcheck.wrap(threading.Lock(), "PersistentDedupIndex._attr_lock")
        self._owner: Dict[bytes, Tuple[str, int]] = {}  # fp -> (tenant, size)
        self._tenant_order: Dict[str, "OrderedDict[bytes, int]"] = {}  # insertion (≈LRU) order
        self._tenant_bytes: Dict[str, int] = {}
        self._tenant_quota: Dict[str, int] = {}
        self._default_quota = default_tenant_quota_bytes
        # monitoring counters (GIL-bumped ints; exact once traffic quiesces)
        self._c_journal_appends = 0
        self._c_journal_bytes = 0
        self._c_torn_dropped = 0
        self._c_compactions = 0
        self._c_warm_hits = 0
        self._c_recovered = 0
        self._c_quota_evictions = 0
        self._recovered_fps: set = set()
        self._journal_lock = lockcheck.wrap(threading.Lock(), "PersistentDedupIndex._journal_lock")
        self._jf = None
        self._recover()
        self._jf = open(self._journal_path, "ab")

    # ---- recovery ----

    def _replay(self, buf: bytes, source: str) -> int:
        """Replay records until the end or the first torn entry; returns the
        byte offset of the last GOOD record boundary."""
        off = 0
        while True:
            rec = _unpack_record(buf, off)
            if rec is None:
                if off < len(buf):
                    self._c_torn_dropped += 1
                    logger.fs.warning(
                        f"[dedup-index] dropping torn tail of {source} at offset {off} "
                        f"({len(buf) - off} trailing bytes)"
                    )
                return off
            kind, fp, size, tenant = rec
            if kind == _KIND_ADD:
                self._apply_add(fp, size, tenant)
            else:
                self._apply_discard(fp)
            off += _REC_LEN

    def _recover(self) -> None:
        """Load snapshot then journal; truncate the journal past a torn tail
        so the next append continues from a clean record boundary."""
        if self._snap_path.exists():
            snap = self._snap_path.read_bytes()
            if snap[: len(_SNAP_MAGIC)] == _SNAP_MAGIC:
                self._replay(snap[len(_SNAP_MAGIC) :], "snapshot")
            else:
                logger.fs.warning("[dedup-index] snapshot has bad magic; ignoring it")
        if self._journal_path.exists():
            buf = self._journal_path.read_bytes()
            good = self._replay(buf, "journal")
            if good < len(buf):
                with open(self._journal_path, "r+b") as f:
                    f.truncate(good)
        # recovered entries above the (possibly shrunken) bound evict now, in
        # the replayed global order — oldest first, the safe direction
        self._evict_to_budget()
        with self._attr_lock:
            self._recovered_fps = set(self._owner)
        self._c_recovered = len(self._recovered_fps)

    def _apply_add(self, fp: bytes, size: int, tenant: str) -> None:
        """Recovery-time insert: base index + attribution, no journaling."""
        SenderDedupIndex.add(self, fp, size)
        with self._attr_lock:
            if fp not in self._owner:
                self._owner[fp] = (tenant, size)
                self._tenant_order.setdefault(tenant, OrderedDict())[fp] = size
                self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + size

    def _apply_discard(self, fp: bytes) -> None:
        SenderDedupIndex.discard(self, fp)
        self._drop_attribution(fp)

    def _drop_attribution(self, fp: bytes) -> None:
        with self._attr_lock:
            owned = self._owner.pop(fp, None)
            if owned is None:
                return
            tenant, size = owned
            order = self._tenant_order.get(tenant)
            if order is not None:
                order.pop(fp, None)
                if not order:
                    del self._tenant_order[tenant]
            self._tenant_bytes[tenant] = max(0, self._tenant_bytes.get(tenant, 0) - size)

    # ---- journaling ----

    def _append(self, kind: int, fp: bytes, size: int, tenant: str) -> None:
        rec = _pack_record(kind, fp, size, tenant)
        inj = get_injector()
        if inj.enabled and inj.fire("index.journal_torn"):
            # torn-write fault (docs/fault-injection.md): persist only a
            # partial record AND stop journaling — exactly what a crash
            # mid-append leaves behind (the tear is at the TAIL; a live
            # journal appending full records after a mid-file tear would be
            # an impossible on-disk state, and recovery truncating at the
            # tear would silently discard them). The in-memory index stays
            # correct for THIS run; the next recovery detects the CRC-broken
            # tail, truncates it, and the lost warmth (the half record plus
            # everything this run would have journaled after it) degrades to
            # literal resends, never corruption.
            with self._journal_lock:
                if self._jf is not None:
                    self._jf.write(rec[: _REC_LEN // 2])
                    self._jf.flush()
                    self._jf.close()
                    self._jf = None
            return
        compact = False
        with self._journal_lock:
            if self._jf is None:
                return  # recovery replay / closed index
            self._jf.write(rec)
            self._jf.flush()
            self._c_journal_appends += 1
            self._c_journal_bytes += len(rec)
            if self._c_journal_bytes >= self._journal_max_bytes:
                compact = True
        if compact:
            self.compact()

    def compact(self) -> None:
        """Snapshot the live entries (global LRU order) and truncate the
        journal. Atomic: snap.tmp + os.replace, then truncate — a crash
        between the two replays a journal whose adds are idempotent.

        The WHOLE pass — entry collection through truncation — runs under
        ``_journal_lock``: a concurrent add/discard would otherwise append
        its record between collection and truncation and have it destroyed
        (a lost DISCARD resurrects a NACK-proven-dead fingerprint at the
        next recovery). Appends block briefly instead; stripe locks nest
        inside the journal lock here only, and no appender holds a stripe
        lock while appending, so the order cannot deadlock."""
        with self._journal_lock:
            if self._jf is None:
                return
            entries = []  # (seq, fp, size)
            for s in self._stripes:
                with s.lock:
                    items = list(s.lru.items())
                for fp, (size, seq) in items:
                    entries.append((seq, fp, size))
            entries.sort()  # ascending seq = oldest first = recovery preserves LRU
            with self._attr_lock:
                owners = dict(self._owner)
            blob = bytearray(_SNAP_MAGIC)
            for _, fp, size in entries:
                tenant = owners.get(fp, (DEFAULT_TENANT_ID, 0))[0]
                blob += _pack_record(_KIND_ADD, fp, size, tenant)
            tmp = self._snap_path.with_name(f"{self._snap_path.name}.tmp{threading.get_ident()}")
            tmp.write_bytes(bytes(blob))
            # durable landing (utils/fsio.py, the unsynced-durable-write bug
            # class): a bare os.replace can truncate the journal below while
            # the new snapshot's bytes are still write-back cache — a badly
            # timed power cut would then lose BOTH (cold restart, not
            # corruption, but the warmth this index exists to keep)
            fsync_replace(tmp, self._snap_path)
            self._jf.close()
            self._jf = open(self._journal_path, "wb")  # truncate
            self._c_journal_bytes = 0
            self._c_compactions += 1

    def close(self) -> None:
        with self._journal_lock:
            if self._jf is not None:
                self._jf.flush()
                self._jf.close()
                self._jf = None

    # ---- mutation (journaled) ----

    def add(self, fp: bytes, size: int = 0, tenant: Optional[str] = None) -> None:
        tenant = tenant or DEFAULT_TENANT_ID
        is_new = fp not in self._owner  # race-tolerant: double-add is idempotent
        if is_new and not self._enforce_tenant_quota(tenant, size):
            # over quota with nothing left of theirs to evict: the entry is
            # NOT admitted — this tenant simply resends literals (its dedup
            # ratio degrades; nobody else's warm set is touched)
            return
        super().add(fp, size)
        if is_new:
            with self._attr_lock:
                if fp in self._owner:
                    return  # lost the insert race: the other writer journaled it
                self._owner[fp] = (tenant, size)
                self._tenant_order.setdefault(tenant, OrderedDict())[fp] = size
                self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + size
            self._append(_KIND_ADD, fp, size, tenant)

    def discard(self, fp: bytes) -> None:
        super().discard(fp)
        had = fp in self._owner
        self._drop_attribution(fp)
        if had:
            # journaled so a recovered index never resurrects a fingerprint a
            # NACK proved unresolvable at the destination
            self._append(_KIND_DISCARD, fp, 0, DEFAULT_TENANT_ID)

    def _note_evicted(self, fp: bytes, size: int) -> None:
        # global capacity eviction: attribution follows the in-memory map.
        # NOT journaled — recovery replays adds in seq order and re-evicts to
        # budget, reaching the same state without one record per eviction.
        self._drop_attribution(fp)

    # ---- per-tenant quotas ----

    def set_tenant_quota(self, tenant: str, max_bytes: Optional[int]) -> None:
        with self._attr_lock:
            if max_bytes is None:
                self._tenant_quota.pop(tenant, None)
            else:
                self._tenant_quota[tenant] = max(0, int(max_bytes))

    def _enforce_tenant_quota(self, tenant: str, incoming: int) -> bool:
        """Evict the tenant's OWN oldest entries until ``incoming`` fits under
        its quota — churn isolated to the offender's warm set. Returns False
        when it can never fit (quota smaller than the entry itself)."""
        while True:
            with self._attr_lock:
                quota = self._tenant_quota.get(tenant, self._default_quota)
                if quota is None or self._tenant_bytes.get(tenant, 0) + incoming <= quota:
                    return True
                order = self._tenant_order.get(tenant)
                if not order:
                    return False  # nothing of theirs left to evict and still over
                victim = next(iter(order))
            self._c_quota_evictions += 1
            self.discard(victim)

    # ---- introspection ----

    def __contains__(self, fp: bytes) -> bool:
        hit = super().__contains__(fp)
        if hit and fp in self._recovered_fps:
            self._c_warm_hits += 1  # fingerprint learned by a PRIOR daemon run
        return hit

    def tenant_bytes(self, tenant: str) -> int:
        with self._attr_lock:
            return self._tenant_bytes.get(tenant, 0)

    def counters(self) -> dict:
        with self._budget_lock:
            total = self._bytes
        with self._attr_lock:
            per_tenant = dict(self._tenant_bytes)
        out = self.remote_counters()  # fleet-gossip tier (dedup_fabric)
        out.update({
            "index_bytes": total,
            "index_entries": len(self),
            "index_journal_appends": self._c_journal_appends,
            "index_journal_bytes": self._c_journal_bytes,
            "index_torn_entries_dropped": self._c_torn_dropped,
            "index_snapshot_compactions": self._c_compactions,
            "index_recovered_entries": self._c_recovered,
            "index_warm_fingerprint_hits": self._c_warm_hits,
            "index_tenant_quota_evictions": self._c_quota_evictions,
            "tenant_index_bytes": per_tenant,  # nested: labelled-provider food
        })
        return out
