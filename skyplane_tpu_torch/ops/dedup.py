"""Cross-object dedup: sender-side fingerprint index, receiver-side segment
store, and the recipe wire format (byte-identical to the JAX package's).

A chunk processed with dedup on becomes a *recipe*: an ordered list of
segments, each either a REF (16-byte fingerprint the receiver already holds)
or a LITERAL (bytes carried in this frame, codec-compressed as one blob).
The wire header flags the payload with ChunkFlags.RECIPE and ``raw_data_len``
keeps the pre-dedup byte count so effective-throughput accounting works
(reference analog: raw_data_len vs data_len bookkeeping in
skyplane/chunk.py:96-155 for compression only).

Consistency contract (SURVEY §7 hard part #3): a sender only emits REF(fp)
after it has previously emitted LITERAL(fp) *on the same ordered channel* (or
learned it from the receiver's index snapshot), and the receiver stores every
literal segment before acking the chunk — so refs always resolve in-order.
Multicast destinations each get their own SenderDedupIndex keyed by
destination gateway id.

``SenderDedupIndex`` and ``SegmentStore`` are the JAX package's, with the
same eviction order, disk spill and counters, so a port gateway and a JAX
one agree on what each side holds. The store's ``fabric`` (the fleet dedup
fabric) stays ``None`` until that module is ported.

Recipe container layout (little-endian):
  magic 0xDE 0xD1 | ver(1) | n_entries(4) | entry... | lit_blob
  entry: kind(1: 0=REF 1=LIT) | fp(16) | seg_len(8)
  lit_blob: codec-compressed concatenation of LITERAL segment bytes.
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from skyplane_tpu_torch.exceptions import CodecException, DedupIntegrityException
from skyplane_tpu_torch.faults import get_injector as _get_injector
from skyplane_tpu_torch.obs.tracer import get_tracer as _get_tracer
from skyplane_tpu_torch.ops.bufpool import BufferPool, bucket_size
from skyplane_tpu_torch.ops.fingerprint import segment_fingerprint_host
from skyplane_tpu_torch.obs import lockwitness as lockcheck

MAGIC = b"\xde\xd1"
VERSION = 1
_ENTRY = struct.Struct("<B16sQ")
KIND_REF = 0
KIND_LIT = 1
# hard cap on the raw bytes a recipe may claim to restore to — mirrors
# chunk.MAX_CHUNK_BYTES without importing the wire module here. A hostile
# entry list must not drive a multi-GiB output allocation before the
# post-restore raw_data_len check ever runs.
MAX_RECIPE_RAW_BYTES = 8 << 30


class _IndexStripe:
    """One lock + one recency-ordered fp map of a striped SenderDedupIndex."""

    __slots__ = ("lock", "lru", "bytes")

    def __init__(self):
        self.lock = lockcheck.wrap(threading.Lock(), "_IndexStripe.lock")
        self.lru: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()  # fp -> (size, last-touch seq)
        self.bytes = 0


class SenderDedupIndex:
    """Bounded LRU of fingerprints known to be resident at one destination.

    Bounded by SEGMENT BYTES, and must be sized strictly below the
    receiver-side SegmentStore capacity (mem + spill): a sender REF to a
    segment the receiver has already evicted is an unrecoverable
    DedupIntegrityException. Default 16 GiB vs the receiver's 4+32 GiB.

    Hot-path striping: ``__contains__`` runs once per SEGMENT per chunk from
    every sender worker (build_recipe), so a single mutex here serializes
    the whole pool. Lookups/inserts lock only the stripe selected by the
    fingerprint's first byte (blake2b output — uniform). Global recency is
    kept via a monotonic touch sequence per entry, so eviction still removes
    the globally least-recently-used fingerprint (each stripe's head is its
    oldest; the evictor picks the minimum-seq head across stripes) and the
    strictly-below-receiver-capacity bound stays a GLOBAL byte bound, not a
    per-stripe approximation. Under concurrent touches eviction is
    approximately-LRU (a head touched between peek and pop may be evicted one
    slot early) — always the SAFE direction: evicting keeps refs resolvable,
    only over-retention can break them.
    """

    def __init__(self, max_bytes: int = 16 << 30, stripes: int = 16):
        import itertools

        n = 1
        while n < max(1, int(stripes)):
            n <<= 1
        self._stripes = [_IndexStripe() for _ in range(n)]
        self._mask = n - 1
        self._seq = itertools.count()  # itertools.count: GIL-atomic next()
        self._budget_lock = lockcheck.wrap(threading.Lock(), "SenderDedupIndex._budget_lock")  # guards the global byte total
        self._max_bytes = max_bytes
        self._bytes = 0
        # fleet-gossiped warmth (dedup_fabric): fingerprints some OTHER
        # gateway proved, learned from summary exchange. Kept apart from the
        # LRU stripes — entry tuples there are (size, seq) and the
        # persistent subclass's compactor iterates them — and bounded by
        # COUNT, not bytes: remote fps consume no receiver capacity at this
        # destination until a REF to one actually resolves (via peer fetch).
        self._remote_lock = lockcheck.wrap(threading.Lock(), "SenderDedupIndex._remote_lock")
        self._remote: "OrderedDict[bytes, int]" = OrderedDict()  # fp -> size
        self._remote_cap = 65536
        self._c_remote_hits = 0
        # fired (fp) when a NACK kills a REF that was emitted on remote
        # warmth — the cross-shard miss the fabric exists to shrink; the
        # daemon binds this to skyplane_cross_shard_nacks_total
        self.on_cross_shard_nack = None

    def _stripe(self, fp: bytes) -> _IndexStripe:
        return self._stripes[fp[0] & self._mask]

    def __contains__(self, fp: bytes) -> bool:
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.get(fp)
            if entry is not None:
                s.lru[fp] = (entry[0], next(self._seq))
                s.lru.move_to_end(fp)
                return True
        # fall through to fleet warmth: "any fleet member proved this fp"
        # is REF-worthy — the receiver resolves it by peer fetch, and a
        # stale entry heals through the ordinary NACK -> discard path
        with self._remote_lock:
            if fp in self._remote:
                self._remote.move_to_end(fp)
                self._c_remote_hits += 1
                return True
        return False

    def add(self, fp: bytes, size: int = 0, tenant: Optional[str] = None) -> None:
        """Insert/touch a fingerprint. ``tenant`` is accepted (and ignored)
        here so call sites can attribute unconditionally; the persistent
        cross-job index subclass uses it for per-tenant byte accounting."""
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.get(fp)
            if entry is not None:
                s.lru[fp] = (entry[0], next(self._seq))
                s.lru.move_to_end(fp)
                return
            s.lru[fp] = (size, next(self._seq))
            s.bytes += size
        with self._remote_lock:
            # locally proved now: the entry graduates out of the gossip tier
            # (double-membership would make discard() miscount a local NACK
            # as a cross-shard one)
            self._remote.pop(fp, None)
        with self._budget_lock:
            self._bytes += size
        self._evict_to_budget()

    def __len__(self) -> int:
        return sum(len(s.lru) for s in self._stripes)

    def discard(self, fp: bytes) -> None:
        """Forget a fingerprint (receiver nacked an unresolvable REF to it)."""
        with self._remote_lock:
            was_remote = self._remote.pop(fp, None) is not None
            hook = self.on_cross_shard_nack if was_remote else None
        if hook is not None:
            # a REF emitted on gossiped fleet warmth died at the destination
            # — the cross-shard fragmentation signal (ROADMAP item 3)
            try:
                hook(fp)
            except Exception:  # noqa: BLE001 — metrics hook must not break NACK recovery
                pass
        s = self._stripe(fp)
        with s.lock:
            entry = s.lru.pop(fp, None)
            if entry is None:
                return
            s.bytes -= entry[0]
        with self._budget_lock:
            self._bytes -= entry[0]

    def add_remote(self, fps, origin: str = "?") -> int:
        """Absorb gossiped fleet warmth: ``fps`` is ``[(fp, size), ...]``
        proved by peer gateway ``origin``. Entries already proved locally are
        skipped; the tier is count-bounded FIFO (stale entries cost one NACK
        each, so over-retention is cheap here, unlike the local LRU)."""
        added = 0
        with self._remote_lock:
            for fp, _size in fps:
                if fp in self._remote:
                    self._remote.move_to_end(fp)
                    continue
                s = self._stripe(fp)
                with s.lock:
                    if fp in s.lru:
                        continue
                self._remote[fp] = _size
                added += 1
            while len(self._remote) > self._remote_cap:
                self._remote.popitem(last=False)
        return added

    def remote_counters(self) -> dict:
        with self._remote_lock:
            return {"index_remote_entries": len(self._remote), "index_remote_hits": self._c_remote_hits}

    def set_max_bytes(self, max_bytes: int) -> None:
        """Rebound the index (multi-source capacity split: each sender takes a
        fair share of the receiver's advertised segment-store capacity).
        Shrinking evicts oldest entries immediately."""
        with self._budget_lock:
            self._max_bytes = max(1, int(max_bytes))
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        """Evict globally-oldest entries until the byte bound holds. Locks
        are taken one stripe at a time (never nested), so the hot path stays
        contention-free while an eviction sweep runs."""
        while True:
            with self._budget_lock:
                if self._bytes <= self._max_bytes:
                    return
            victim: Optional[_IndexStripe] = None
            victim_seq = None
            for s in self._stripes:
                with s.lock:
                    if s.lru:
                        _, (_, seq) = next(iter(s.lru.items()))
                        if victim_seq is None or seq < victim_seq:
                            victim, victim_seq = s, seq
            if victim is None:
                return  # nothing left to evict
            with victim.lock:
                if not victim.lru:
                    continue  # raced with a discard; rescan
                vfp, (size, _) = victim.lru.popitem(last=False)
                victim.bytes -= size
            with self._budget_lock:
                self._bytes -= size
            self._note_evicted(vfp, size)

    def _note_evicted(self, fp: bytes, size: int) -> None:
        """Capacity-eviction hook (no locks held): the persistent cross-job
        index (tenancy/persistent_index.py) overrides this to keep per-tenant
        byte attribution coherent with the in-memory map."""

    @property
    def max_bytes(self) -> int:
        return self._max_bytes


class _StoreStripe:
    """One lock + its share of the in-memory fp map of a striped SegmentStore."""

    __slots__ = ("lock", "mem", "waiters", "contended")

    def __init__(self):
        self.lock = lockcheck.wrap(threading.Lock(), "_StoreStripe.lock")
        self.mem: "OrderedDict[bytes, list]" = OrderedDict()  # fp -> [data, last-touch seq]
        # fp -> [arrival Event, waiter refcount]: REFs that raced ahead of
        # their LITERAL park here and wake the moment put() lands the bytes
        self.waiters: Dict[bytes, list] = {}
        self.contended = 0  # monitoring counter (GIL increments; approximate)


class SegmentStore:
    """Receiver-side fingerprint -> segment bytes store.

    In-memory LRU bounded by bytes, with optional disk spill directory so the
    working set can exceed RAM (gateway VMs stage chunks on disk anyway,
    reference: skyplane/gateway/chunk_store.py:108-109).

    Hot-path striping (the receiver mirror of ``SenderDedupIndex``): every
    decode worker resolves one ``get``/``put`` per SEGMENT, so a single mutex
    here serializes the whole decode pool — and the old implementation held
    that mutex across spill-file disk reads and a 1-second-granularity
    ref-arrival poll. Now:

      * lookups/inserts lock only the stripe selected by the fingerprint's
        first byte (blake2b output — uniform);
      * the byte bound stays GLOBAL with globally-ordered eviction via a
        monotonic touch sequence (evictor pops the minimum-seq stripe head,
        exactly the SenderDedupIndex scheme — approximately-LRU under races,
        always in the safe direction);
      * disk I/O (spill writes, spill reads, promotion reads) happens with NO
        store lock held; an ``_in_transit`` map keeps evictees resolvable
        during the off-lock spill write;
      * a REF arriving before its LITERAL waits on a per-fingerprint arrival
        event set by ``put`` — no polling, wake latency is scheduler-bound.
    """

    def __init__(
        self,
        max_bytes: int = 4 << 30,
        spill_dir: Optional[Path] = None,
        spill_max_bytes: int = 32 << 30,
        stripes: int = 16,
        persistent_spill: bool = False,
    ):
        n = 1
        while n < max(1, int(stripes)):
            n <<= 1
        self._stripes = [_StoreStripe() for _ in range(n)]
        self._mask = n - 1
        self._seq = itertools.count()  # itertools.count: GIL-atomic next()
        self._budget_lock = lockcheck.wrap(threading.Lock(), "SegmentStore._budget_lock")  # guards the global mem byte total
        self._max_bytes = max_bytes
        self._mem_bytes = 0
        self._spill_dir = Path(spill_dir) if spill_dir else None
        self._spill_max_bytes = spill_max_bytes
        self._spill_lock = lockcheck.wrap(threading.Lock(), "SegmentStore._spill_lock")  # guards spill index + in-transit map
        self._spill_bytes = 0
        self._spill_order: "OrderedDict[bytes, int]" = OrderedDict()  # fp -> size, recency order
        # segments popped from memory whose spill write is still in flight:
        # membership here keeps them resolvable during the off-lock disk write
        self._in_transit: Dict[bytes, bytes] = {}
        self._adopted_spill_count = 0
        if self._spill_dir:
            self._spill_dir.mkdir(parents=True, exist_ok=True)
            if persistent_spill:
                # cross-restart dedup (tenancy persistent index): adopt prior
                # runs' spilled segments — content-addressed files landed via
                # tmp+os.replace, so anything named *.seg is complete and
                # correct. Only orphaned .tmp files from a crashed writer are
                # swept. Senders recovering their persistent fingerprint
                # index REF these across a daemon restart.
                for stale in self._spill_dir.glob("*.seg.tmp*"):
                    stale.unlink()
                for seg in sorted(self._spill_dir.glob("*.seg")):
                    try:
                        fp = bytes.fromhex(seg.stem)
                        if len(fp) != 16:
                            raise ValueError(seg.stem)
                    except ValueError:
                        seg.unlink()  # not a content-addressed segment file
                        continue
                    self._spill_order[fp] = seg.stat().st_size
                    self._spill_bytes += self._spill_order[fp]
                    self._adopted_spill_count += 1
            else:
                # spill is per-run state: stale files from a previous daemon
                # would never be REF'd (fresh sender index) but would eat disk
                # forever (*.seg* also sweeps orphaned .tmp files)
                for stale in self._spill_dir.glob("*.seg*"):
                    stale.unlink()
        self._tls = threading.local()  # per-thread held-lock depth (disk-read audit)
        # monitoring counters: plain ints bumped under the GIL — monotonic and
        # exact once traffic quiesces, which is all /profile needs
        self._c_mem_hits = 0
        self._c_spill_reads = 0
        self._c_promotions = 0
        self._c_lock_held_disk_reads = 0
        self._c_ref_wait_ns = 0
        self._c_ref_timeouts = 0
        self._c_mem_evictions = 0
        self._c_spill_evictions = 0
        self._c_spill_write_failures = 0
        # consecutive spill-write failures before escalation (any success
        # resets): a transient disk error degrades gracefully — the evictee is
        # dropped and later REFs to it recover via NACK -> literal resend —
        # but a persistently failing spill disk must surface daemon-fatal,
        # not silently halve the dedup working set forever
        self._spill_fail_streak = 0
        self.max_spill_write_failures = 32
        # fleet dedup fabric (dedup_fabric.DedupFabric), attached by the
        # daemon after construction. When set, a REF miss tries ONE peer
        # fetch from the ring owner before parking on the arrival event, and
        # every landed literal feeds write-through placement via note_put.
        self.fabric = None
        self._c_fabric_hits = 0

    # ---- lock discipline ----

    @contextmanager
    def _hold(self, lock: threading.Lock, stripe: Optional[_StoreStripe] = None):
        """Acquire a store lock, counting stripe contention and tracking the
        per-thread held-lock depth so ``_read_spill_file`` can prove (via the
        ``store_lock_held_disk_reads`` counter) that no disk read ever runs
        inside a critical section."""
        if not lock.acquire(False):
            if stripe is not None:
                stripe.contended += 1
            lock.acquire()
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        try:
            yield
        finally:
            self._tls.depth -= 1
            lock.release()

    def _stripe(self, fp: bytes) -> _StoreStripe:
        return self._stripes[fp[0] & self._mask]

    def _spill_path(self, fp: bytes) -> Optional[Path]:
        return self._spill_dir / f"{fp.hex()}.seg" if self._spill_dir else None

    # ---- writes ----

    def put(self, fp: bytes, data: bytes) -> None:
        self._insert(fp, data)
        self._evict_to_budget()
        if self.fabric is not None:
            # landed literal: feed the gossip summary + write-through
            # placement. Peer-fetched segments enter via _insert directly,
            # so a fetch never push-loops back to the gateway it came from.
            self.fabric.note_put(fp, data)

    def _insert(self, fp: bytes, data: bytes) -> None:
        """Insert into the striped in-memory map and wake any parked REFs."""
        s = self._stripe(fp)
        added = 0
        with self._hold(s.lock, s):
            entry = s.mem.get(fp)
            if entry is not None:
                entry[1] = next(self._seq)
                s.mem.move_to_end(fp)
            else:
                s.mem[fp] = [data, next(self._seq)]
                added = len(data)
            waiter = s.waiters.pop(fp, None)
        if waiter is not None:
            waiter[0].set()  # outside the stripe lock; waiters re-check under it
        if added:
            with self._hold(self._budget_lock):
                self._mem_bytes += added

    def _evict_to_budget(self) -> None:
        """Evict globally-oldest segments to spill until the byte bound holds.
        Locks are taken one stripe at a time; the spill-file write runs with
        no lock held (the evictee stays resolvable via ``_in_transit``)."""
        while True:
            with self._hold(self._budget_lock):
                if self._mem_bytes <= self._max_bytes:
                    return
            victim: Optional[_StoreStripe] = None
            victim_seq = None
            for s in self._stripes:
                with self._hold(s.lock, s):
                    if s.mem:
                        head = next(iter(s.mem.values()))
                        if victim_seq is None or head[1] < victim_seq:
                            victim, victim_seq = s, head[1]
            if victim is None:
                return  # nothing left to evict
            with self._hold(victim.lock, victim):
                if not victim.mem:
                    continue  # raced with another evictor; rescan
                vfp, (data, _) = victim.mem.popitem(last=False)
                if self._spill_dir is not None:
                    # stage for spill INSIDE the stripe lock (stripe -> spill
                    # nesting, this one site only) so a concurrent get()
                    # always finds the segment in mem ∪ in_transit ∪ spill
                    with self._hold(self._spill_lock):
                        self._in_transit[vfp] = data
            with self._hold(self._budget_lock):
                self._mem_bytes -= len(data)
            self._c_mem_evictions += 1
            if self._spill_dir is not None:
                self._spill_out(vfp, data)

    def _spill_out(self, fp: bytes, data: bytes) -> None:
        """Persist an evictee to the spill tier and enforce the spill byte
        bound. Called with NO lock held; the file write is off-lock."""
        with self._hold(self._spill_lock):
            known = fp in self._spill_order
            if known:
                # already on disk from an earlier eviction: refresh recency
                self._spill_order.move_to_end(fp)
                self._in_transit.pop(fp, None)
        if not known:
            # atomic landing (temp + rename): two evictors can race the same
            # fp (evict -> in-transit promote -> evict again), and a
            # truncating in-place write would let a reader see a short or
            # hole-zeroed file. Spill content is content-addressed (same fp
            # => identical bytes), so whichever replace wins, readers always
            # see one complete, correct file.
            p = self._spill_path(fp)
            tmp = p.with_name(f"{p.name}.tmp{threading.get_ident()}")
            try:
                inj = _get_injector()
                tracer = _get_tracer()
                with tracer.span("spill.write", cat="store", args={"bytes": len(data)} if tracer.enabled else None):
                    if inj.enabled:
                        inj.check("store.spill_write", OSError, "injected spill-write failure")
                    tmp.write_bytes(data)
                    os.replace(tmp, p)
            except OSError as e:
                # disk failure: drop the in-transit pin and DROP the evictee —
                # a vanished segment is the NACK contract's job (an
                # unresolvable REF nacks, the sender discards the fp and
                # resends literals), so a transient spill failure degrades the
                # dedup ratio, never correctness. A persistent failure streak
                # still escalates: the disk is gone, say so loudly.
                with self._hold(self._spill_lock):
                    self._in_transit.pop(fp, None)
                try:
                    tmp.unlink()
                except OSError:
                    pass
                with self._hold(self._spill_lock):
                    # serialized: concurrent evictors racing bare += could
                    # drop increments and defer the escalation indefinitely
                    self._c_spill_write_failures += 1
                    self._spill_fail_streak += 1
                    streak = self._spill_fail_streak
                if streak >= self.max_spill_write_failures:
                    raise OSError(
                        f"spill tier failed {streak} consecutive writes "
                        f"(latest: {e}); spill disk unusable"
                    ) from e
                from skyplane_tpu_torch.utils.logger import logger as _logger

                _logger.fs.warning(
                    f"[segment-store] spill write failed ({e}); dropped segment {fp.hex()} "
                    f"(degrades to NACK/literal-resend; streak {streak}/{self.max_spill_write_failures})"
                )
                # fleet-log the degradation (docs/observability.md): a post-
                # mortem reading NACK storms needs to see the spill failures
                # that seeded them, in order, next to everything else
                from skyplane_tpu_torch.obs.events import EV_SPILL_DEGRADED, get_recorder

                get_recorder().record(
                    EV_SPILL_DEGRADED, fp=fp.hex(), streak=streak, error=str(e)[:200]
                )
                return
            with self._hold(self._spill_lock):
                self._spill_fail_streak = 0
                self._in_transit.pop(fp, None)
                if fp in self._spill_order:
                    # raced a concurrent spill of the same fp (evict ->
                    # promote -> evict again): registering twice would
                    # permanently inflate the spill byte accounting
                    self._spill_order.move_to_end(fp)
                else:
                    self._spill_order[fp] = len(data)
                    self._spill_bytes += len(data)
        # bound spill disk usage: drop the LEAST-RECENTLY-USED spilled
        # segments (get() refreshes recency, so retention here stays coherent
        # with the sender's LRU index — a hot segment the sender keeps
        # REF'ing is never the one evicted). Unlinks run off-lock.
        drops: List[bytes] = []
        with self._hold(self._spill_lock):
            while self._spill_bytes > self._spill_max_bytes and self._spill_order:
                drop_fp, drop_sz = self._spill_order.popitem(last=False)
                self._spill_bytes -= drop_sz
                drops.append(drop_fp)
        for drop_fp in drops:
            self._c_spill_evictions += 1
            dp = self._spill_path(drop_fp)
            try:
                dp.unlink()
            except OSError:
                pass  # already gone (readers tolerate a vanished file)

    # ---- reads ----

    def _read_spill_file(self, fp: bytes) -> Optional[bytes]:
        """The one place spill bytes are read from disk. Counts (rather than
        assumes) lock discipline: a read issued while this thread holds any
        store lock bumps ``store_lock_held_disk_reads`` — asserted zero under
        contention in the unit tests."""
        if getattr(self._tls, "depth", 0):
            self._c_lock_held_disk_reads += 1
        p = self._spill_path(fp)
        try:
            inj = _get_injector()
            with _get_tracer().span("spill.read", cat="store"):
                if inj.enabled:
                    # a failed spill read is already a recovery contract: the
                    # miss propagates to an unresolvable REF -> NACK ->
                    # literal resend (docs/fault-injection.md)
                    inj.check("store.spill_read", OSError, "injected spill-read failure")
                data = p.read_bytes()
        except OSError:
            return None  # raced with spill eviction (or the disk failed): treat as a miss
        self._c_spill_reads += 1
        return data

    def _spill_get(self, fp: bytes) -> Optional[bytes]:
        """Resolve from the spill tier (or the in-transit window). Membership
        is checked under the spill lock; the disk read happens outside it."""
        if self._spill_dir is None:
            return None
        with self._hold(self._spill_lock):
            data = self._in_transit.get(fp)
            if data is not None:
                return data
            if fp not in self._spill_order:
                return None
            self._spill_order.move_to_end(fp)
        return self._read_spill_file(fp)

    def get(self, fp: bytes, wait_timeout: float = 0.0) -> bytes:
        """Resolve a fingerprint, optionally blocking for in-flight literals.

        With parallel sender sockets (and parallel decode workers) a REF can
        land before its LITERAL (SURVEY §7 hard part #3); ``wait_timeout`` > 0
        parks the caller on a per-fingerprint arrival event that ``put`` sets
        the moment the literal lands — a bounded wait with no poll tick.

        Hits refresh recency on BOTH tiers (memory LRU touch; spill hits are
        promoted back into memory), so receiver retention dominates the
        sender index's LRU — a segment the sender still REFs stays resolvable.
        """
        deadline = time.monotonic() + wait_timeout
        s = self._stripe(fp)
        tried_fabric = False
        while True:
            with self._hold(s.lock, s):
                entry = s.mem.get(fp)
                if entry is not None:
                    entry[1] = next(self._seq)
                    s.mem.move_to_end(fp)
                    self._c_mem_hits += 1
                    return entry[0]
            data = self._spill_get(fp)
            if data is not None:
                self._insert(fp, data)  # promote hot spilled segment to memory
                self._evict_to_budget()
                self._c_promotions += 1
                return data
            if self.fabric is not None and not tried_fabric:
                # both local tiers missed: one peer fetch from the ring owner
                # before parking. Strictly an optimization rung — fetch()
                # returns None on any trouble and the miss proceeds to the
                # arrival wait / NACK ladder unchanged. Once per get: a
                # second attempt could not succeed where the first failed
                # inside the same ref-wait window, it would only double the
                # deadline burned before the NACK.
                tried_fabric = True
                data = self.fabric.fetch(fp)
                if data is not None:
                    # _insert (not put): peer-fetched bytes must not re-feed
                    # note_put, or two gateways would ping-pong pushes
                    self._insert(fp, data)
                    self._evict_to_budget()
                    self._c_fabric_hits += 1
                    return data
            # miss: park on the per-fp arrival event. Re-check membership
            # AFTER registering (under the stripe lock) so a put() landing
            # between the lookups above and the registration cannot be lost.
            with self._hold(s.lock, s):
                entry = s.mem.get(fp)
                if entry is not None:
                    entry[1] = next(self._seq)
                    s.mem.move_to_end(fp)
                    self._c_mem_hits += 1
                    return entry[0]
                waiter = s.waiters.get(fp)
                if waiter is None:
                    waiter = s.waiters[fp] = [threading.Event(), 0]
                waiter[1] += 1
            try:
                # close the put -> immediate-evict race: the literal may have
                # landed AND been evicted to the spill tier between the spill
                # miss above and the registration — eviction never fires
                # arrival events, so without this re-check the waiter would
                # park the full timeout for a segment that is resolvable now
                data = self._spill_get(fp)
                if data is not None:
                    fired = None  # resolved via spill; no wait happened
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        fired = False
                    else:
                        t0 = time.perf_counter_ns()
                        fired = waiter[0].wait(remaining)
                        self._c_ref_wait_ns += time.perf_counter_ns() - t0
            finally:
                with self._hold(s.lock, s):
                    waiter[1] -= 1
                    if waiter[1] <= 0 and not waiter[0].is_set() and s.waiters.get(fp) is waiter:
                        del s.waiters[fp]  # last waiter gone and never satisfied
            if fired is None:
                self._insert(fp, data)  # promote, as on the ordinary spill-hit path
                self._evict_to_budget()
                self._c_promotions += 1
                return data
            if not fired:
                self._c_ref_timeouts += 1
                raise DedupIntegrityException(f"unresolvable dedup ref {fp.hex()}")
            # the literal (or a spill transition) landed: retry the lookup

    def peek(self, fp: bytes) -> Optional[bytes]:
        """Non-blocking local-only resolve for the fabric's owner-side serve
        path: memory or spill, no arrival wait, no peer fetch (a serving
        gateway must never recurse into the fabric — two cold owners would
        fetch from each other until both deadlines burn), no promotion and
        no ref-timeout accounting (a peer's probe is not a datapath miss)."""
        s = self._stripe(fp)
        with self._hold(s.lock, s):
            entry = s.mem.get(fp)
            if entry is not None:
                entry[1] = next(self._seq)
                s.mem.move_to_end(fp)
                return entry[0]
        return self._spill_get(fp)

    def __contains__(self, fp: bytes) -> bool:
        # membership must be read under the owning locks: probing spill PATHS
        # without them raced spill eviction (file unlinked between the mem
        # miss and the exists() probe -> false positive/negative flapping)
        s = self._stripe(fp)
        with self._hold(s.lock, s):
            if fp in s.mem:
                return True
        if self._spill_dir is None:
            return False
        with self._hold(self._spill_lock):
            return fp in self._in_transit or fp in self._spill_order

    def flush_to_spill(self) -> None:
        """Evict the whole memory tier to the spill directory (graceful
        shutdown with persistent dedup: the next daemon adopts the spilled
        segments, so sender indexes recovered from their journals resolve
        instead of NACK-storming). No-op without a spill dir."""
        if self._spill_dir is None:
            return
        with self._hold(self._budget_lock):
            old = self._max_bytes
            self._max_bytes = 1
        try:
            self._evict_to_budget()
        finally:
            with self._hold(self._budget_lock):
                self._max_bytes = old

    def set_bounds(self, max_bytes: Optional[int] = None, spill_max_bytes: Optional[int] = None) -> None:
        """Rebound the store (capacity-starvation tests, adaptive sizing).
        Shrinking the memory bound evicts immediately; the spill bound is
        enforced as evictees flow through the spill tier."""
        if max_bytes is not None:
            with self._hold(self._budget_lock):
                self._max_bytes = max(1, int(max_bytes))
        if spill_max_bytes is not None:
            with self._hold(self._spill_lock):
                self._spill_max_bytes = max(0, int(spill_max_bytes))
        self._evict_to_budget()

    # ---- introspection ----

    @property
    def mem_segment_count(self) -> int:
        return sum(len(s.mem) for s in self._stripes)

    @property
    def capacity_bytes(self) -> int:
        """Total retention capacity (memory + spill) — advertised to source
        gateways so their SenderDedupIndex bounds split it fairly."""
        return self._max_bytes + (self._spill_max_bytes if self._spill_dir else 0)

    def counters(self) -> dict:
        """Decode-side health counters (merged into the receiver's stable
        decode-counter schema; see docs/datapath-performance.md)."""
        with self._hold(self._budget_lock):
            mem_bytes = self._mem_bytes
        with self._hold(self._spill_lock):
            spill_bytes = self._spill_bytes
        return {
            "store_mem_hits": self._c_mem_hits,
            "store_spill_reads": self._c_spill_reads,
            "store_promotions": self._c_promotions,
            "store_lock_held_disk_reads": self._c_lock_held_disk_reads,
            "store_stripe_contention": sum(s.contended for s in self._stripes),
            "store_ref_wait_ns": self._c_ref_wait_ns,
            "store_ref_timeouts": self._c_ref_timeouts,
            "store_mem_evictions": self._c_mem_evictions,
            "store_spill_evictions": self._c_spill_evictions,
            "store_mem_bytes": mem_bytes,
            "store_spill_bytes": spill_bytes,
            "store_spill_adopted": self._adopted_spill_count,
            "store_spill_write_failures": self._c_spill_write_failures,
            "store_fabric_hits": self._c_fabric_hits,
        }


def build_recipe(
    segments: List[Tuple[bytes, bytes]],  # [(fp16, seg_bytes), ...] in order
    index: SenderDedupIndex,
    encode_blob,
) -> Tuple[bytes, int, int, List[bytes], List[bytes]]:
    """Assemble a recipe for one chunk.

    Returns (wire_bytes, n_ref_segments, n_literal_bytes_pre_codec,
    new_fingerprints as [(fp, size), ...], ref_fingerprints as [fp, ...]).
    The index is NOT mutated here: the caller must commit
    ``new_fingerprints`` via ``index.add(fp, size)`` only after the frame is
    successfully delivered (acked) — otherwise a failed send would poison the
    index and later retries would emit REFs the receiver cannot resolve.
    ``ref_fingerprints`` lets the caller *discard* those entries if the
    receiver nacks an unresolvable REF, so the retry resends literals.
    Repeats *within* this chunk are still deduped (they travel in the same
    frame, so in-order resolution is guaranteed).
    """
    entries = bytearray()
    lit_parts: List[bytes] = []
    emitted_here: set = set()
    new_fps: List[bytes] = []
    ref_fps: List[bytes] = []
    for fp, seg in segments:
        if fp in index or fp in emitted_here:
            entries += _ENTRY.pack(KIND_REF, fp, len(seg))
            ref_fps.append(fp)
        else:
            entries += _ENTRY.pack(KIND_LIT, fp, len(seg))
            lit_parts.append(seg)
            emitted_here.add(fp)
            new_fps.append((fp, len(seg)))
    lit_blob = encode_blob(b"".join(lit_parts))
    head = MAGIC + struct.pack("<BI", VERSION, len(segments))
    return head + bytes(entries) + lit_blob, len(ref_fps), sum(len(p) for p in lit_parts), new_fps, ref_fps


class PooledChunk:
    """Restored chunk bytes assembled in a pooled buffer (zero extra copies).

    ``view`` is a memoryview over exactly the chunk's bytes; callers hand it
    straight to the sink (file write / socket send) and then ``release()``
    the underlying buffer back to its pool. The view must not be touched
    after release — release() invalidates it so misuse raises, never aliases
    another chunk's bytes.
    """

    __slots__ = ("_arr", "_pool", "view")

    def __init__(self, arr: np.ndarray, pool: BufferPool, n: int):
        self._arr = arr
        self._pool = pool
        self.view = memoryview(arr)[:n]

    def __len__(self) -> int:
        return len(self.view)

    def release(self) -> None:
        if self._arr is None:
            return  # idempotent
        self.view.release()
        self._pool.release(self._arr)
        self._arr = None


def parse_recipe(
    buf: bytes,
    store: SegmentStore,
    decode_blob,
    ref_wait_timeout: float = 0.0,
    verify_literals: bool = False,
    out_pool: Optional[BufferPool] = None,
    expected_raw_len: Optional[int] = None,
):
    """Receiver side: resolve a recipe back into raw chunk bytes.

    ``expected_raw_len`` (the wire header's ``raw_data_len``) is checked
    against the entry-claimed total BEFORE any buffer allocation or store
    work — a hostile entry list must not size an allocation, and the
    mismatch fails fast instead of after a full restore.

    Every literal segment is inserted into ``store`` so later refs resolve.
    With ``verify_literals``, each literal's fingerprint is recomputed before
    admission — a corrupted literal stored under a healthy fingerprint would
    propagate to every future chunk that REFs it.

    With ``out_pool``, segments are assembled directly into a pooled output
    buffer (one copy per segment, no intermediate list + ``b"".join`` pass)
    and a :class:`PooledChunk` is returned instead of ``bytes``; the caller
    writes its ``view`` out and releases it. Without a pool the historical
    ``bytes`` return is unchanged.
    """
    head_len = 2 + struct.calcsize("<BI")
    if len(buf) < head_len or buf[:2] != MAGIC:
        raise CodecException("not a dedup recipe (bad magic / truncated header)")
    ver, n_entries = struct.unpack_from("<BI", buf, 2)
    if ver != VERSION:
        raise CodecException(f"unsupported recipe version {ver}")
    off = head_len
    # bound the claimed entry count by the bytes actually present — a hostile
    # or corrupted count must not crash the handler or drive huge allocations
    if n_entries * _ENTRY.size > len(buf) - off:
        raise CodecException(f"recipe claims {n_entries} entries but only {len(buf) - off} bytes follow")
    entries = []
    total = 0
    for _ in range(n_entries):
        kind, fp, seg_len = _ENTRY.unpack_from(buf, off)
        off += _ENTRY.size
        entries.append((kind, fp, seg_len))
        total += seg_len
    if total > MAX_RECIPE_RAW_BYTES:
        raise CodecException(f"recipe claims {total} raw bytes (> {MAX_RECIPE_RAW_BYTES} cap)")
    if expected_raw_len is not None and total != expected_raw_len:
        raise CodecException(f"recipe entries claim {total} raw bytes but the header declared {expected_raw_len}")
    lit_blob = decode_blob(buf[off:])
    arr: Optional[np.ndarray] = None
    if out_pool is not None and total > 0:
        arr = out_pool.acquire(bucket_size(total))
    out: List[bytes] = []
    out_off = 0
    lit_off = 0
    try:
        for kind, fp, seg_len in entries:
            if kind == KIND_LIT:
                seg = lit_blob[lit_off : lit_off + seg_len]
                if len(seg) != seg_len:
                    raise DedupIntegrityException("literal blob shorter than recipe entries")
                lit_off += seg_len
                if verify_literals:
                    if segment_fingerprint_host(seg) != fp:
                        raise DedupIntegrityException(f"literal segment fingerprint mismatch (claimed {fp.hex()})")
                store.put(fp, seg)
            elif kind == KIND_REF:
                seg = store.get(fp, wait_timeout=ref_wait_timeout)
                if len(seg) != seg_len:
                    raise DedupIntegrityException(f"dedup ref {fp.hex()} length mismatch")
            else:
                raise CodecException(f"bad recipe entry kind {kind}")
            if arr is not None:
                arr[out_off : out_off + seg_len] = np.frombuffer(seg, np.uint8)
                out_off += seg_len
            else:
                out.append(seg)
        if lit_off != len(lit_blob):
            raise DedupIntegrityException("literal blob longer than recipe entries")
    except BaseException:
        if arr is not None:
            out_pool.release(arr)  # a failed decode must not leak the buffer
        raise
    if arr is not None:
        return PooledChunk(arr, out_pool, total)
    return b"".join(out)
