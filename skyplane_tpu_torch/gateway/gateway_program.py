"""Gateway program IR: the operator-DAG description planners ship to gateways.

Reference parity: skyplane/gateway/gateway_program.py:34-159 (same op
vocabulary: Send/Receive/ReadObjectStore/WriteObjectStore/GenData/WriteLocal/
MuxAnd/MuxOr; same add_operator(parent_handle, partition_id) tree building and
partition-grouped ``to_dict``). Data-path extensions: GatewaySend carries
``codec``/``dedup`` (accepted on the GPU data path), and GatewayReceive
carries ``dedup`` so the receiver builds a SegmentStore.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


class GatewayOp:
    op_type = "op"

    def __init__(self, handle: Optional[str] = None):
        self.handle = handle
        self.children: List["GatewayOp"] = []

    def add_child(self, child: "GatewayOp") -> None:
        self.children.append(child)

    def to_dict(self) -> dict:
        return {
            "op_type": self.op_type,
            "handle": self.handle,
            "children": [c.to_dict() for c in self.children],
        }

    def _extra(self) -> dict:
        return {}


class GatewaySend(GatewayOp):
    op_type = "send"

    def __init__(
        self,
        target_gateway_id: str,
        region: str,
        num_connections: int = 32,
        compress: str = "none",
        encrypt: bool = False,
        dedup: bool = False,
        private_ip: bool = False,
        peer_serve: bool = False,
        raw_eligible: Optional[bool] = None,
        handle: Optional[str] = None,
    ):
        super().__init__(handle)
        self.target_gateway_id = target_gateway_id
        self.region = region
        self.num_connections = num_connections
        self.compress = compress
        self.encrypt = encrypt
        self.dedup = dedup
        self.private_ip = private_ip
        # blast relay tree (blast/, docs/blast.md): this send
        # runs on a DESTINATION gateway serving already-landed chunks to a
        # sibling sink; arms the relay.peer_serve fault point
        self.peer_serve = peer_serve
        # raw-forward planner hint (docs/datapath-performance.md): True/False
        # force the sendfile fast path on/off for this edge; None defers to
        # the operator default (on, modulo SKYPLANE_TPU_RAW_FORWARD)
        self.raw_eligible = raw_eligible

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(
            target_gateway_id=self.target_gateway_id,
            region=self.region,
            num_connections=self.num_connections,
            compress=self.compress,
            encrypt=self.encrypt,
            dedup=self.dedup,
            private_ip=self.private_ip,
            peer_serve=self.peer_serve,
            raw_eligible=self.raw_eligible,
        )
        return d


class GatewayReceive(GatewayOp):
    op_type = "receive"

    def __init__(self, decrypt: bool = False, dedup: bool = False, max_pending_chunks: int = 1000, handle: Optional[str] = None):
        super().__init__(handle)
        self.decrypt = decrypt
        self.dedup = dedup
        self.max_pending_chunks = max_pending_chunks

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(decrypt=self.decrypt, dedup=self.dedup, max_pending_chunks=self.max_pending_chunks)
        return d


class GatewayReadObjectStore(GatewayOp):
    op_type = "read_object_store"

    def __init__(self, bucket_name: str, bucket_region: str, num_connections: int = 32, handle: Optional[str] = None):
        super().__init__(handle)
        self.bucket_name = bucket_name
        self.bucket_region = bucket_region
        self.num_connections = num_connections

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(bucket_name=self.bucket_name, bucket_region=self.bucket_region, num_connections=self.num_connections)
        return d


class GatewayWriteObjectStore(GatewayOp):
    op_type = "write_object_store"

    def __init__(self, bucket_name: str, bucket_region: str, num_connections: int = 32, handle: Optional[str] = None):
        super().__init__(handle)
        self.bucket_name = bucket_name
        self.bucket_region = bucket_region
        self.num_connections = num_connections

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(bucket_name=self.bucket_name, bucket_region=self.bucket_region, num_connections=self.num_connections)
        return d


class GatewayGenData(GatewayOp):
    op_type = "gen_data"

    def __init__(self, size_mb: int, handle: Optional[str] = None):
        super().__init__(handle)
        self.size_mb = size_mb

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(size_mb=self.size_mb)
        return d


class GatewayWriteLocal(GatewayOp):
    op_type = "write_local"

    def __init__(self, path: Optional[str] = None, handle: Optional[str] = None):
        super().__init__(handle)
        self.path = path

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(path=self.path)
        return d


class GatewayReadLocal(GatewayOp):
    op_type = "read_local"

    def __init__(self, path: Optional[str] = None, num_connections: int = 16, handle: Optional[str] = None):
        super().__init__(handle)
        self.path = path
        self.num_connections = num_connections

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(path=self.path, num_connections=self.num_connections)
        return d


class GatewayMuxAnd(GatewayOp):
    op_type = "mux_and"


class GatewayMuxOr(GatewayOp):
    op_type = "mux_or"


_OP_CLASSES = {
    c.op_type: c
    for c in (
        GatewaySend,
        GatewayReceive,
        GatewayReadObjectStore,
        GatewayWriteObjectStore,
        GatewayGenData,
        GatewayWriteLocal,
        GatewayReadLocal,
        GatewayMuxAnd,
        GatewayMuxOr,
    )
}


class GatewayProgram:
    """Per-gateway operator tree(s), one forest per partition set.

    ``add_operator(op, parent_handle, partition_id)`` mirrors the reference
    API (gateway_program.py:100-159); ``to_dict`` groups partitions with
    identical programs.
    """

    def __init__(self):
        self._ops: Dict[str, Dict[str, GatewayOp]] = defaultdict(dict)  # partition -> handle -> op
        self._roots: Dict[str, List[GatewayOp]] = defaultdict(list)
        self._counter = 0

    def get_operators(self, partition_id: str = "default") -> Dict[str, GatewayOp]:
        return self._ops[partition_id]

    def add_operator(self, op: GatewayOp, parent_handle: Optional[str] = None, partition_id: str = "default") -> str:
        if op.handle is None:
            self._counter += 1
            op.handle = f"operator_{self._counter}"
        if op.handle in self._ops[partition_id]:
            raise ValueError(f"duplicate operator handle {op.handle} in partition {partition_id}")
        self._ops[partition_id][op.handle] = op
        if parent_handle is None:
            self._roots[partition_id].append(op)
        else:
            parent = self._ops[partition_id].get(parent_handle)
            if parent is None:
                raise ValueError(f"unknown parent handle {parent_handle}")
            parent.add_child(op)
        return op.handle

    def to_dict(self) -> dict:
        # group partitions that share an identical program (reference :138-159)
        per_partition = {
            pid: [root.to_dict() for root in roots] for pid, roots in self._roots.items()
        }
        groups: List[dict] = []
        for pid, prog in per_partition.items():
            serialized = json.dumps(prog, sort_keys=True)
            for g in groups:
                if g["_key"] == serialized:
                    g["partitions"].append(pid)
                    break
            else:
                groups.append({"partitions": [pid], "value": prog, "_key": serialized})
        return {"plan": [{"partitions": g["partitions"], "value": g["value"]} for g in groups]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def op_from_dict(d: dict) -> GatewayOp:
        cls = _OP_CLASSES.get(d["op_type"])
        if cls is None:
            raise ValueError(f"unknown op_type {d['op_type']!r}")
        kwargs = {k: v for k, v in d.items() if k not in ("op_type", "children")}
        op = cls(**kwargs)
        for child in d.get("children", []):
            op.add_child(GatewayProgram.op_from_dict(child))
        return op
