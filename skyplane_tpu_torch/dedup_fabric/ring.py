"""Consistent-hash ring: fingerprint -> owning gateway, stable under churn.

Placement must satisfy three contracts the fabric's correctness (and the
fleet's dedup ratio) hangs off:

  * **determinism** — every member computes the same owner for every
    fingerprint from the membership list alone; there is no coordinator.
  * **minimal remap** — a single join/leave moves ~1/N of the keyspace
    (virtual nodes smooth per-node share), so one gateway churning does not
    cold-start the whole fleet's warmth.
  * **replacement adoption** — a replacement gateway (PR-10 tracker
    machinery) joins with its dead predecessor's *seat*, occupying exactly
    the same ring positions: every fingerprint the dead node owned maps to
    the replacement, which adopts the spilled segment state on disk.

Seats make adoption trivial: a node's virtual-node positions are hashed from
its seat (default: its own id), not its identity — ``add_node("gw-new",
seat="gw-dead")`` reproduces gw-dead's positions bit for bit while lookups
report the live node id.

Draining gateways (PR-10 ``draining_gateway_ids``) stay ON the ring —
removing them would remap 1/N of the keyspace for a transient state — but
``owner(fp, exclude=draining)`` walks past them to the next live successor,
so fetches and write-through pushes never target a gateway that is flushing
to stop.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_VNODES = 64

#: sorts after any real node id at the same position (bisect tie-break)
_MAX_NODE_ID = chr(0x10FFFF)


def _hash_pos(data: bytes) -> int:
    """Ring position in [0, 2^64): blake2b so vnode positions mix with the
    (already blake2b-derived) segment fingerprints uniformly."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Sorted-entries consistent-hash ring with seats (see module docstring).

    Not thread-safe by itself: the fabric mutates it only under its own lock
    and lookups snapshot the sorted entry list.
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        self.vnodes = max(1, int(vnodes))
        self._seats: Dict[str, str] = {}  # node_id -> seat
        self._entries: List[Tuple[int, str]] = []  # sorted (position, node_id)

    # ---- membership ----

    def __len__(self) -> int:
        return len(self._seats)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._seats

    def nodes(self) -> List[str]:
        return sorted(self._seats)

    def seat_of(self, node_id: str) -> Optional[str]:
        return self._seats.get(node_id)

    def add_node(self, node_id: str, seat: Optional[str] = None) -> None:
        """Join ``node_id``; with ``seat`` set to a departed node's id the
        newcomer adopts that node's exact ring positions (replacement
        adoption). Re-adding an existing node with a different seat moves it."""
        if node_id in self._seats:
            if self._seats[node_id] == (seat or node_id):
                return
            self.remove_node(node_id)
        seat = seat or node_id
        self._seats[node_id] = seat
        for i in range(self.vnodes):
            pos = _hash_pos(f"{seat}:{i}".encode())
            bisect.insort(self._entries, (pos, node_id))

    def remove_node(self, node_id: str) -> Optional[str]:
        """Leave the ring; returns the freed seat so a replacement can adopt
        it, or None when the node was never a member."""
        seat = self._seats.pop(node_id, None)
        if seat is None:
            return None
        self._entries = [(p, n) for (p, n) in self._entries if n != node_id]
        return seat

    # ---- lookup ----

    def owner(self, fp: bytes, exclude: Iterable[str] = ()) -> Optional[str]:
        """The live owner of ``fp``: the first ring successor of the
        fingerprint's position whose node is not excluded (draining). None
        when the ring is empty or fully excluded."""
        if not self._entries:
            return None
        excluded = set(exclude)
        if excluded and not (self._seats.keys() - excluded):
            return None
        pos = _hash_pos(fp)
        idx = bisect.bisect_right(self._entries, (pos, _MAX_NODE_ID))
        n = len(self._entries)
        for step in range(n):
            node = self._entries[(idx + step) % n][1]
            if node not in excluded:
                return node
        return None

    def owners(self, fp: bytes, count: int, exclude: Iterable[str] = ()) -> List[str]:
        """The first ``count`` DISTINCT non-excluded successors (primary
        first) — replication-aware callers without a second lookup pass."""
        if not self._entries or count <= 0:
            return []
        excluded = set(exclude)
        pos = _hash_pos(fp)
        idx = bisect.bisect_right(self._entries, (pos, _MAX_NODE_ID))
        n = len(self._entries)
        out: List[str] = []
        for step in range(n):
            node = self._entries[(idx + step) % n][1]
            if node in excluded or node in out:
                continue
            out.append(node)
            if len(out) >= count:
                break
        return out
