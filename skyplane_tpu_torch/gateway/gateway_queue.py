"""Chunk queues wiring operator DAG stages.

Reference parity: skyplane/gateway/gateway_queue.py:4-62 (GatewayQueue fan-in
/ GatewayANDQueue multicast replication). Thread-based queues (queue.Queue)
instead of multiprocessing.Queue — operators are threads in this runtime.
"""

from __future__ import annotations

import queue
from typing import Dict, List, Optional

from skyplane_tpu_torch.chunk import ChunkRequest


class GatewayQueue:
    """Shared FIFO: multiple producers, workers of all registered handles compete (OR semantics)."""

    def __init__(self, maxsize: int = 0):
        self.q: "queue.Queue[ChunkRequest]" = queue.Queue(maxsize)
        self.handles: List[str] = []

    def register_handle(self, handle: str) -> None:
        self.handles.append(handle)

    def put(self, chunk_req: ChunkRequest) -> None:
        self.q.put(chunk_req)

    def put_for_handle(self, handle: str, chunk_req: ChunkRequest) -> None:
        """Return a chunk to the queue feeding ``handle`` only (requeue path).

        On a shared (OR) queue this is a plain put — any competing sibling may
        legitimately pick the chunk up."""
        self.q.put(chunk_req)

    def pop(self, requester_handle: str = "", timeout: Optional[float] = None) -> ChunkRequest:
        return self.q.get(timeout=timeout) if timeout else self.q.get_nowait()

    def get_nowait(self, requester_handle: str = "") -> ChunkRequest:
        return self.q.get_nowait()

    def size(self) -> int:
        return self.q.qsize()


class GatewayANDQueue(GatewayQueue):
    """Multicast queue: ``put`` replicates the chunk to every registered handle
    (AND semantics for MuxAnd fan-out; reference: gateway_queue.py:31-62)."""

    def __init__(self, maxsize: int = 0):
        super().__init__(maxsize)
        self.subqueues: Dict[str, GatewayQueue] = {}

    def register_handle(self, handle: str) -> None:
        self.handles.append(handle)
        self.subqueues[handle] = GatewayQueue()

    def get_handle_queue(self, handle: str) -> GatewayQueue:
        return self.subqueues[handle]

    def put(self, chunk_req: ChunkRequest) -> None:
        for handle in self.handles:
            self.subqueues[handle].put(chunk_req)

    def put_for_handle(self, handle: str, chunk_req: ChunkRequest) -> None:
        """Requeue to one branch's sub-queue without re-multicasting."""
        self.subqueues[handle].put(chunk_req)

    def get_nowait(self, requester_handle: str = "") -> ChunkRequest:
        return self.subqueues[requester_handle].get_nowait()

    def pop(self, requester_handle: str = "", timeout: Optional[float] = None) -> ChunkRequest:
        q = self.subqueues[requester_handle]
        return q.q.get(timeout=timeout) if timeout else q.q.get_nowait()

    def size(self) -> int:
        return max((q.size() for q in self.subqueues.values()), default=0)
