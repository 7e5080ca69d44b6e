"""DedupFabric: the per-process half of the fleet-wide segment namespace.

One instance per daemon (and per pump worker process) holding:

  * the ring + membership (``configure`` — from the ``SKYPLANE_TPU_FABRIC``
    env, ``POST /api/v1/fabric/membership``, or a pump worker's cfg dict);
  * **peer fetch** — ``fetch(fp)`` resolves a receiver-side REF miss from
    the ring owner via ``GET /api/v1/segment/<fp>``: bounded concurrency
    (semaphore), a per-peer circuit breaker whose open window reuses
    :class:`RetryPolicy`'s backoff schedule, and a hard deadline after which
    the caller's existing NACK -> literal-resend path fires unchanged.
    Fetched bytes are fingerprint-verified before anyone trusts them — a
    corrupt peer response is a miss, never a poisoned store;
  * **write-through placement** — ``note_put(fp, data)`` on every landed
    literal asynchronously pushes segments whose ring owner is another
    gateway to that owner (bounded queue, best-effort), so placement
    converges toward the ring without a rebalance pass;
  * **summary gossip** — ``summary()``/``absorb()`` exchange recently-proved
    fingerprints so every SenderDedupIndex partition (pump workers included)
    treats "any fleet member proved this fp" as durable warmth. A stale
    entry degrades to one NACK -> literal resend; it cannot corrupt.

Failure semantics (docs/dedup-fabric.md): every branch of ``fetch`` returns
None on trouble — breaker open, semaphore saturated, HTTP error, timeout,
fingerprint mismatch, injected ``fabric.peer_fetch`` fault — and the caller
falls through to the pre-existing ref-wait/NACK ladder. Peer fetch can only
remove literal resends, never add failure modes.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from skyplane_tpu_torch.dedup_fabric.ring import DEFAULT_VNODES, ConsistentHashRing
from skyplane_tpu_torch.faults import get_injector
from skyplane_tpu_torch.utils.logger import logger
from skyplane_tpu_torch.utils.retry import RetryPolicy
from skyplane_tpu_torch.obs import lockwitness as lockcheck

#: membership JSON (inline, or a file path): {"members": [{"id", "url",
#: "token"?, "seat"?}, ...], "draining": [...], "vnodes": 64}
FABRIC_ENV = "SKYPLANE_TPU_FABRIC"

#: stable counter schema (zeros when the fabric is unconfigured) — merged
#: into decode counters by pump workers and scraped via /api/v1/metrics
FABRIC_COUNTER_ZERO = {
    "fabric_members": 0,
    "fabric_peer_fetch_hits": 0,
    "fabric_peer_fetch_misses": 0,
    "fabric_peer_fetch_timeouts": 0,
    "fabric_peer_fetch_bytes": 0,
    "fabric_breaker_skips": 0,
    "fabric_breaker_opens": 0,
    "fabric_pushes_sent": 0,
    "fabric_pushes_dropped": 0,
    "fabric_push_failures": 0,
    "fabric_summaries_absorbed": 0,
    "fabric_fps_absorbed": 0,
    "fabric_serves": 0,
    "fabric_serves_sealed": 0,
    "fabric_serve_misses": 0,
    "fabric_lands": 0,
    "fabric_land_rejects": 0,
}

#: the circuit breaker's open-window schedule IS a RetryPolicy backoff
#: ladder (jitter decorrelates a fleet re-probing a recovered peer); shared
#: by every breaker so the knobs live in one place
_BREAKER_POLICY = RetryPolicy(max_attempts=1, initial_backoff=0.5, max_backoff=15.0, jitter=0.3)

#: breaker trips after this many consecutive failures to one peer
_BREAKER_TRIP = 3


def _content_matches(fp: bytes, data: bytes) -> bool:
    """Verify fetched bytes against the requested fingerprint. Two 16-byte
    content-address namespaces coexist on the wire: dedup SEGMENT
    fingerprints (polynomial lanes, ops/fingerprint.py) and chunk/sealed
    frame fingerprints (blake2b-128 of the bytes). Either match proves the
    peer served exactly the content asked for; neither proves the wrong
    content, so accepting both keeps the PR-17 sealed raw path serveable
    through the same route without weakening the check."""
    import hashlib

    if hashlib.blake2b(data, digest_size=16).digest() == fp:
        return True
    from skyplane_tpu_torch.ops.fingerprint import MAX_SEGMENT_BYTES, segment_fingerprint_host

    if len(data) > MAX_SEGMENT_BYTES:
        return False
    return segment_fingerprint_host(data) == fp


class _PeerBreaker:
    """Per-peer circuit breaker: consecutive failures open a window sized by
    the shared RetryPolicy's backoff ladder (failure count = attempt index),
    so a dead peer costs one deadline per window instead of one per REF."""

    __slots__ = ("failures", "open_until")

    def __init__(self):
        self.failures = 0
        self.open_until = 0.0

    def is_open(self, now: float) -> bool:
        return now < self.open_until

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure (re)opened the breaker."""
        self.failures += 1
        if self.failures < _BREAKER_TRIP:
            return False
        attempt = self.failures - _BREAKER_TRIP
        self.open_until = now + _BREAKER_POLICY.backoff_s(min(attempt, 12))
        return True

    def record_success(self) -> None:
        self.failures = 0
        self.open_until = 0.0


class DedupFabric:
    def __init__(
        self,
        gateway_id: str,
        *,
        membership: Optional[dict] = None,
        fetch_deadline_s: Optional[float] = None,
        max_concurrent_fetches: Optional[int] = None,
        summary_cap: int = 8192,
        push_queue_cap: int = 256,
        serve_spill_roots: Iterable[Path] = (),
    ):
        self.gateway_id = gateway_id
        # must stay comfortably below the receiver's ref_wait_timeout (10 s
        # default) AND the sender's 30 s data-socket timeout: a fetch that
        # outlives the ref wait just burns the NACK it was trying to save
        if fetch_deadline_s is None:
            fetch_deadline_s = float(os.environ.get("SKYPLANE_TPU_FABRIC_FETCH_DEADLINE_S", "4.0") or 4.0)
        self.fetch_deadline_s = max(0.1, fetch_deadline_s)
        if max_concurrent_fetches is None:
            max_concurrent_fetches = int(os.environ.get("SKYPLANE_TPU_FABRIC_FETCH_CONCURRENCY", "4") or 4)
        self._sem = threading.BoundedSemaphore(max(1, max_concurrent_fetches))
        self._lock = lockcheck.wrap(threading.Lock(), "DedupFabric._lock")
        self._ring = ConsistentHashRing()
        self._members: Dict[str, dict] = {}  # id -> {"url","token","seat"}
        self._draining: set = set()
        self._breakers: Dict[str, _PeerBreaker] = {}
        self._sessions: Dict[str, object] = {}  # peer id -> control_auth.ControlSession
        # recently-proved local fps (landed literals + served pushes): the
        # gossip summary. Bounded LRU — gossip is an optimization feed, the
        # durable truth stays in the per-target persistent indexes.
        self._recent: "OrderedDict[bytes, int]" = OrderedDict()  # fp -> size
        self._recent_cap = max(64, int(summary_cap))
        # fps absorbed FROM peers, kept to seed sender indexes created after
        # the summary arrived (same bound; stale entries heal via NACK)
        self._absorbed: "OrderedDict[bytes, int]" = OrderedDict()
        self._absorb_sinks: List[Callable[[List[Tuple[bytes, int]], str], None]] = []
        # write-through push queue: bounded and best-effort — a full queue
        # drops the push (counted), the segment still serves from here
        self._push_q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=max(8, push_queue_cap))
        self._push_thread: Optional[threading.Thread] = None
        self._closed = False
        # extra spill roots the segment route may serve from (pump-worker
        # shard spill dirs under the parent daemon's chunk_dir)
        self._serve_spill_roots = [Path(p) for p in serve_spill_roots]
        # owner-side serve sources, attached by the daemon after construction:
        # the receiver's SegmentStore and the ChunkStore's sealed-frame cache
        self.local_store = None
        self.chunk_store = None
        # histogram observe hook (daemon wires skyplane_peer_fetch_seconds)
        self.fetch_observe: Optional[Callable[[float], None]] = None
        # membership fan-out: the daemon registers a listener that rebroadcasts
        # new membership docs to pump worker processes (their fabrics bootstrap
        # from the inherited env; dynamic updates arrive via ctrl messages)
        self.configure_listeners: List[Callable[[dict], None]] = []
        self._c = dict(FABRIC_COUNTER_ZERO)
        if membership:
            self.configure(membership)

    # ---- membership ----

    @property
    def configured(self) -> bool:
        with self._lock:
            return bool(self._members)

    def configure(self, membership: dict) -> None:
        """(Re)build ring + member table from a membership document. Seats
        let a replacement adopt its predecessor's positions; the previous
        draining set is replaced wholesale (the tracker's
        ``draining_gateway_ids`` snapshot is the source of truth)."""
        members = membership.get("members") or []
        vnodes = int(membership.get("vnodes") or DEFAULT_VNODES)
        ring = ConsistentHashRing(vnodes=vnodes)
        table: Dict[str, dict] = {}
        for m in members:
            node_id = str(m.get("id") or "")
            if not node_id:
                continue
            ring.add_node(node_id, seat=m.get("seat") or None)
            table[node_id] = {"url": str(m.get("url") or ""), "token": m.get("token"), "seat": m.get("seat")}
        with self._lock:
            self._ring = ring
            self._members = table
            self._draining = set(membership.get("draining") or ())
            self._c["fabric_members"] = len(table)
            # members that left take their breaker/session state with them
            for gone in set(self._breakers) - set(table):
                self._breakers.pop(gone, None)
                self._sessions.pop(gone, None)
        if table and self._push_thread is None and not self._closed:
            t = threading.Thread(target=self._push_loop, name="fabric-push", daemon=True)
            self._push_thread = t
            t.start()
        for listener in list(self.configure_listeners):
            try:
                listener(membership)
            except Exception as e:  # noqa: BLE001 — a dead pump pool must not fail a membership push
                logger.fs.warning(f"[fabric:{self.gateway_id}] configure listener failed: {e}")

    def set_draining(self, gateway_ids: Iterable[str]) -> None:
        """Refresh the excluded set from the PR-10 tracker machinery without
        a full membership rebuild (drain is transient; ring positions keep)."""
        with self._lock:
            self._draining = set(gateway_ids)

    def membership(self) -> dict:
        """The current membership document (tokens redacted) — served by
        ``GET /api/v1/fabric/summary`` for introspection and soak gates."""
        with self._lock:
            return {
                "vnodes": self._ring.vnodes,
                "members": [
                    {"id": gid, "url": m["url"], "seat": m.get("seat")} for gid, m in sorted(self._members.items())
                ],
                "draining": sorted(self._draining),
            }

    def owner_of(self, fp: bytes) -> Optional[str]:
        with self._lock:
            return self._ring.owner(fp, exclude=self._draining)

    # ---- peer fetch (the REF-miss optimization rung) ----

    def fetch(self, fp: bytes) -> Optional[bytes]:
        """Fetch one segment from its ring owner; None on ANY trouble (the
        caller proceeds to its existing ref-wait/NACK ladder). Verified
        against the fingerprint before returning."""
        with self._lock:
            owner = self._ring.owner(fp, exclude=self._draining)
            member = self._members.get(owner) if owner else None
        if member is None or owner == self.gateway_id or not member.get("url"):
            if member is not None or owner == self.gateway_id:
                self._c["fabric_peer_fetch_misses"] += 1
            return None
        now = time.monotonic()
        with self._lock:
            breaker = self._breakers.setdefault(owner, _PeerBreaker())
            if breaker.is_open(now):
                self._c["fabric_breaker_skips"] += 1
                return None
        if not self._sem.acquire(timeout=min(1.0, self.fetch_deadline_s)):
            # fetch pool saturated: skipping is cheaper than queueing past
            # the ref-wait deadline (the REF just resolves the old way)
            self._c["fabric_peer_fetch_timeouts"] += 1
            return None
        t0 = time.monotonic()
        try:
            inj = get_injector()
            if inj.enabled:
                # docs/fault-injection.md `fabric.peer_fetch`: the peer's
                # response is dropped/delayed past the deadline — the REF
                # falls through to NACK -> literal resend, byte-identical
                inj.check("fabric.peer_fetch", TimeoutError, "injected peer-fetch drop")
            data = self._http_get_segment(owner, member, fp)
        except TimeoutError:
            self._c["fabric_peer_fetch_timeouts"] += 1
            self._record_peer_failure(owner)
            return None
        except Exception as e:  # noqa: BLE001 — every fetch failure degrades to the NACK ladder
            from skyplane_tpu_torch.gateway.control_auth import ControlTimeout

            timeout_like = isinstance(e, (ControlTimeout, TimeoutError))
            self._c["fabric_peer_fetch_timeouts" if timeout_like else "fabric_peer_fetch_misses"] += 1
            self._record_peer_failure(owner)
            logger.fs.debug(f"[fabric:{self.gateway_id}] peer fetch {fp.hex()[:12]} from {owner} failed: {e}")
            return None
        finally:
            self._sem.release()
        elapsed = time.monotonic() - t0
        if self.fetch_observe is not None:
            self.fetch_observe(elapsed)
        if data is None:
            # clean 404: the owner is healthy but cold (placement still
            # converging, or the segment aged out) — not a breaker strike
            self._c["fabric_peer_fetch_misses"] += 1
            with self._lock:
                b = self._breakers.get(owner)
                if b is not None:
                    b.record_success()
            return None
        if not _content_matches(fp, data):
            # a corrupt response must never enter the store under a healthy
            # fingerprint — that would spread to every chunk REF'ing it
            self._c["fabric_peer_fetch_misses"] += 1
            self._record_peer_failure(owner)
            logger.fs.warning(f"[fabric:{self.gateway_id}] peer {owner} served corrupt segment {fp.hex()}")
            return None
        self._c["fabric_peer_fetch_hits"] += 1
        self._c["fabric_peer_fetch_bytes"] += len(data)
        with self._lock:
            b = self._breakers.get(owner)
            if b is not None:
                b.record_success()
        return data

    def _record_peer_failure(self, owner: str) -> None:
        now = time.monotonic()
        with self._lock:
            breaker = self._breakers.setdefault(owner, _PeerBreaker())
            if breaker.record_failure(now):
                self._c["fabric_breaker_opens"] += 1
                logger.fs.warning(
                    f"[fabric:{self.gateway_id}] circuit breaker open for peer {owner} "
                    f"({breaker.failures} consecutive failures)"
                )

    def _session_for(self, owner: str, member: dict):
        with self._lock:
            sess = self._sessions.get(owner)
        if sess is None:
            from skyplane_tpu_torch.gateway.control_auth import control_session

            sess = control_session(member.get("token"))
            with self._lock:
                self._sessions.setdefault(owner, sess)
                sess = self._sessions[owner]
        return sess

    def _http_get_segment(self, owner: str, member: dict, fp: bytes) -> Optional[bytes]:
        """One authenticated GET to the owner's segment route. Returns the
        raw bytes, None on 404 (cold owner), raises on transport trouble."""
        url = member["url"].rstrip("/")
        if not url.endswith("/api/v1"):
            url += "/api/v1"
        resp = self._session_for(owner, member).get(f"{url}/segment/{fp.hex()}", timeout=self.fetch_deadline_s)
        if resp.status_code == 404:
            return None
        resp.raise_for_status()
        return resp.content

    # ---- write-through placement + summary feed ----

    def note_put(self, fp: bytes, data: bytes) -> None:
        """Called by the SegmentStore on every landed literal: records local
        warmth for the gossip summary and (when the ring owner is another
        gateway) enqueues a best-effort write-through push so placement
        converges toward the ring."""
        with self._lock:
            if not self._members:
                return
            self._recent[fp] = len(data)
            self._recent.move_to_end(fp)
            while len(self._recent) > self._recent_cap:
                self._recent.popitem(last=False)
            owner = self._ring.owner(fp, exclude=self._draining)
            member = self._members.get(owner) if owner else None
        if owner is None or owner == self.gateway_id or member is None or not member.get("url"):
            return
        try:
            self._push_q.put_nowait((owner, fp, data))
        except queue.Full:
            self._c["fabric_pushes_dropped"] += 1

    def _push_loop(self) -> None:
        while True:
            item = self._push_q.get()
            if item is None:
                return
            owner, fp, data = item
            with self._lock:
                member = self._members.get(owner)
                breaker = self._breakers.setdefault(owner, _PeerBreaker())
                skip = member is None or breaker.is_open(time.monotonic())
            if skip:
                self._c["fabric_pushes_dropped"] += 1
                continue
            try:
                url = member["url"].rstrip("/")
                if not url.endswith("/api/v1"):
                    url += "/api/v1"
                resp = self._session_for(owner, member).post(
                    f"{url}/segment/{fp.hex()}", data=data, timeout=self.fetch_deadline_s
                )
                resp.raise_for_status()
                self._c["fabric_pushes_sent"] += 1
                with self._lock:
                    breaker.record_success()
            except Exception as e:  # noqa: BLE001 — pushes are best-effort; a miss heals via peer fetch/NACK
                self._c["fabric_push_failures"] += 1
                self._record_peer_failure(owner)
                logger.fs.debug(f"[fabric:{self.gateway_id}] write-through push to {owner} failed: {e}")

    # ---- summary gossip ----

    def summary(self) -> dict:
        """Recently-proved local fingerprints for one gossip round."""
        with self._lock:
            fps = [[fp.hex(), size] for fp, size in self._recent.items()]
        return {"gateway": self.gateway_id, "fps": fps}

    def absorb(self, summary: dict) -> int:
        """Absorb one peer summary: remembered for late-created sender
        indexes and fanned out to the registered sinks (live sender indexes,
        pump worker broadcast). Returns the number of fps absorbed."""
        origin = str(summary.get("gateway") or "?")
        batch: List[Tuple[bytes, int]] = []
        for item in summary.get("fps") or ():
            try:
                hexfp, size = (item[0], item[1]) if isinstance(item, (list, tuple)) else (item, 0)
                fp = bytes.fromhex(hexfp)
                if len(fp) != 16:
                    continue
            except (ValueError, TypeError, IndexError):
                continue
            batch.append((fp, int(size or 0)))
        if not batch:
            return 0
        with self._lock:
            for fp, size in batch:
                self._absorbed[fp] = size
                self._absorbed.move_to_end(fp)
            while len(self._absorbed) > self._recent_cap:
                self._absorbed.popitem(last=False)
            sinks = list(self._absorb_sinks)
        for sink in sinks:
            try:
                sink(batch, origin)
            except Exception as e:  # noqa: BLE001 — one bad sink must not drop the round for the rest
                logger.fs.warning(f"[fabric:{self.gateway_id}] absorb sink failed: {e}")
        self._c["fabric_summaries_absorbed"] += 1
        self._c["fabric_fps_absorbed"] += len(batch)
        return len(batch)

    def absorbed_fps(self) -> List[Tuple[bytes, int]]:
        """Everything absorbed so far (bounded) — seeds sender dedup indexes
        instantiated after the summaries arrived."""
        with self._lock:
            return list(self._absorbed.items())

    def add_absorb_sink(self, sink: Callable[[List[Tuple[bytes, int]], str], None]) -> None:
        with self._lock:
            self._absorb_sinks.append(sink)

    # ---- serving (owner side of peer fetch) ----

    def serve(self, fp: bytes) -> Optional[bytes]:
        """Resolve one ``GET /api/v1/segment/<fp>`` as the owner. The ladder
        is strictly local — never the fabric itself (two cold owners must not
        fetch from each other until both deadlines burn):

          1. SegmentStore ``peek`` — memory/spill, no arrival wait;
          2. sealed-frame cache by fingerprint — the PR-17 raw path: the
             already-framed payload serves without decode or recompress
             (borrow/release proved by the resource-lifecycle pass);
          3. pump-worker shard spill files under the shared chunk_dir.
        """
        store = self.local_store
        if store is not None:
            data = store.peek(fp)
            if data is not None:
                self._c["fabric_serves"] += 1
                return data
        cs = self.chunk_store
        if cs is not None:
            ref = cs.sealed_open_by_fp(fp.hex())
            if ref is not None:
                try:
                    data = os.pread(ref.fd, ref.length, 0)
                finally:
                    ref.close()
                self._c["fabric_serves"] += 1
                self._c["fabric_serves_sealed"] += 1
                return data
        data = self.serve_from_spill(fp)
        if data is not None:
            self._c["fabric_serves"] += 1
            return data
        self._c["fabric_serve_misses"] += 1
        return None

    def land(self, fp: bytes, data: bytes) -> bool:
        """Accept one write-through push (``POST /api/v1/segment/<fp>``):
        verify the bytes ARE the fingerprint's content, then store them so
        later peer fetches hit. Landing through ``put`` records the fp in
        this gateway's own gossip summary (owner == self, so no push loop)."""
        if not _content_matches(fp, data):
            self._c["fabric_land_rejects"] += 1
            logger.fs.warning(f"[fabric:{self.gateway_id}] rejected pushed segment {fp.hex()}: content mismatch")
            return False
        store = self.local_store
        if store is None:
            self._c["fabric_land_rejects"] += 1
            return False
        store.put(fp, data)
        self._c["fabric_lands"] += 1
        return True

    def serve_from_spill(self, fp: bytes) -> Optional[bytes]:
        """Owner-side fallback behind the SegmentStore: pump-worker shard
        spill directories share the parent's chunk_dir, so the parent can
        serve their spilled segments without a worker round trip. Files land
        via tmp+rename (content-addressed), so anything named ``<fp>.seg``
        is complete; the fetcher re-verifies the fingerprint regardless."""
        name = f"{fp.hex()}.seg"
        for root in self._serve_spill_roots:
            try:
                candidates = [root / name] + sorted(p / name for p in root.glob("pump*"))
            except OSError:
                continue
            for path in candidates:
                try:
                    return path.read_bytes()
                except OSError:
                    continue
        return None

    # ---- introspection / shutdown ----

    def counters(self) -> dict:
        out = dict(self._c)
        out["fabric_push_queue_depth"] = self._push_q.qsize()
        return out

    def close(self) -> None:
        self._closed = True
        if self._push_thread is not None:
            try:
                self._push_q.put_nowait(None)
            except queue.Full:
                pass
            self._push_thread.join(timeout=2.0)
            self._push_thread = None


def membership_from_env() -> Optional[dict]:
    """Parse SKYPLANE_TPU_FABRIC: inline JSON, or a path to a JSON file."""
    raw = (os.environ.get(FABRIC_ENV) or "").strip()
    if not raw:
        return None
    if not raw.lstrip().startswith("{"):
        try:
            raw = Path(raw).read_text()
        except OSError as e:
            logger.fs.warning(f"ignoring unreadable {FABRIC_ENV} file: {e}")
            return None
    try:
        doc = json.loads(raw)
    except ValueError as e:
        logger.fs.warning(f"ignoring malformed {FABRIC_ENV}: {e}")
        return None
    return doc if isinstance(doc, dict) else None


def fabric_from_env(gateway_id: str, **kwargs) -> DedupFabric:
    """A fabric seeded from SKYPLANE_TPU_FABRIC when set (unconfigured — and
    inert — otherwise); membership can still arrive later via the API."""
    return DedupFabric(gateway_id, membership=membership_from_env(), **kwargs)
