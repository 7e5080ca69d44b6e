"""Blast planner: jobs with K destinations -> a planner-placed relay tree.

Unlike :class:`~skyplane_tpu_torch.planner.planner.MulticastDirectPlanner` (the
fallback rung, which fans the source out to every destination and pays K
source-egress copies), the blast planner makes the destination gateways
*peer*: the tree solver (blast/tree.py) places a degree-bounded min-cost
arborescence over the egress grid, the source sends to its tree children
only, and every interior destination gateway re-serves landed chunks to its
children over the ordinary wire protocol (``GatewaySend(peer_serve=True)``).
Peer sends run the full data path per edge — codec + dedup against the
serving gateway's own :class:`PersistentDedupIndex` partition for that
target — so a repeat blast (checkpoint delta) ships only new fingerprints on
every edge, and a stale warm index degrades through the established
NACK -> literal-resend path, never corruption (docs/blast.md).

The planner also emits loopback-harness programs
(:func:`build_local_blast_programs`) so the soak, the bench, and the tier-1
integration test exercise the exact program shapes the cloud path ships.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from skyplane_tpu_torch.api.config import TransferConfig
from skyplane_tpu_torch.gateway.gateway_program import (
    GatewayMuxAnd,
    GatewayReadObjectStore,
    GatewayReceive,
    GatewaySend,
    GatewayWriteObjectStore,
)
from skyplane_tpu_torch.planner.planner import MulticastDirectPlanner, Planner, record_planner_downgrade
from skyplane_tpu_torch.planner.topology import TopologyPlan
from skyplane_tpu_torch.blast.tree import (
    DEFAULT_FANOUT,
    DEFAULT_SOURCE_DEGREE,
    BlastTree,
    solve_blast_tree,
    validate_tree,
)


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var, str(default)))
    except ValueError:
        return default


class BlastPlanner(Planner):
    """Multicast relay-tree planner (``--solver blast``, docs/blast.md)."""

    def __init__(
        self,
        transfer_config: TransferConfig,
        fanout: Optional[int] = None,
        source_degree: Optional[int] = None,
        tree_solver: str = "auto",
        cost_fn=None,
        **kw,
    ):
        super().__init__(transfer_config, **kw)
        self.fanout = fanout if fanout is not None else _env_int("SKYPLANE_TPU_BLAST_FANOUT", DEFAULT_FANOUT)
        self.source_degree = (
            source_degree
            if source_degree is not None
            else _env_int("SKYPLANE_TPU_BLAST_SOURCE_DEGREE", DEFAULT_SOURCE_DEGREE)
        )
        self.tree_solver = tree_solver
        self.cost_fn = cost_fn
        self.last_tree: Optional[BlastTree] = None

    def plan(self, jobs: List) -> TopologyPlan:
        src_region, dst_regions = self._validate_jobs(jobs)
        self.codec_decisions = {}  # fresh per plan
        self.last_tree = None
        if len(dst_regions) < 2:
            # a single destination has no siblings to peer with: the direct
            # planner IS the optimal tree. Accounted like every planner
            # fallback so a caller expecting fan-out sees why it got direct.
            record_planner_downgrade("blast_tree", "multicast_direct", "single_destination")
            plan = MulticastDirectPlanner(
                self.transfer_config, quota_limits_file=self.quota_limits_file, n_instances=self.n_instances
            ).plan(jobs)
            plan.metadata["downgraded_from"] = "blast_tree"
            plan.metadata["downgrade_reason"] = "single_destination"
            return plan

        cfg = self.transfer_config
        plan = TopologyPlan(src_region, dst_regions)
        vm_types, _ = self._get_vm_type_and_instances(
            [src_region] + sorted({r for r in dst_regions if r != src_region})
        )
        # one gateway per endpoint: the source, and one sink per destination
        # (same-region destinations included — a same-region sink is still a
        # peer that can serve siblings)
        src_gw = plan.add_gateway(src_region)
        sink_gws = [plan.add_gateway(region) for region in dst_regions]
        sink_regions = {gw.gateway_id: gw.region_tag for gw in sink_gws}
        tree = solve_blast_tree(
            src_gw.gateway_id,
            sink_regions,
            src_region,
            cost_fn=self.cost_fn,
            fanout=self.fanout,
            source_degree=self.source_degree,
            solver=self.tree_solver,
        )
        validate_tree(tree)
        self.last_tree = tree

        estimate = self._estimate_corpus(jobs) if any(r != src_region for r in dst_regions) else None
        gw_by_id = {gw.gateway_id: gw for gw in [src_gw] + sink_gws}
        for job in jobs:
            partition = job.uuid
            iface_by_sink = {gw.gateway_id: iface for gw, iface in zip(sink_gws, job.dst_ifaces)}
            # source: read -> send(s) to the tree children (degree-bounded —
            # THIS is where blast beats direct multicast on source egress)
            program = src_gw.gateway_program
            read_h = program.add_operator(
                GatewayReadObjectStore(
                    bucket_name=job.src_iface.bucket(), bucket_region=src_region, num_connections=cfg.num_connections
                ),
                partition_id=partition,
            )
            self._add_sends(
                program, read_h, partition, src_region, tree.children(src_gw.gateway_id), gw_by_id, estimate,
                peer_serve=False,
            )
            # sinks: receive -> write (+ peer-serve sends for interior nodes)
            for gw in sink_gws:
                program = gw.gateway_program
                recv_h = program.add_operator(
                    GatewayReceive(decrypt=cfg.encrypt_e2e, dedup=self._sink_dedup(tree, gw, estimate)),
                    partition_id=partition,
                )
                children = tree.children(gw.gateway_id)
                parent_h = recv_h
                if children:
                    parent_h = program.add_operator(GatewayMuxAnd(), parent_handle=recv_h, partition_id=partition)
                iface = iface_by_sink[gw.gateway_id]
                program.add_operator(
                    GatewayWriteObjectStore(
                        bucket_name=iface.bucket(), bucket_region=gw.region_tag, num_connections=cfg.num_connections
                    ),
                    parent_handle=parent_h,
                    partition_id=partition,
                )
                if children:
                    self._add_sends(
                        program, parent_h, partition, gw.region_tag, children, gw_by_id, estimate, peer_serve=True
                    )
        for gw in plan.gateways.values():
            gw.vm_type = vm_types.get(gw.region_tag)
        plan.cost_per_gb = tree.cost_per_gb
        plan.codec_decisions = dict(self.codec_decisions)
        plan.planner_name = "blast_tree"
        plan.metadata["tree"] = tree.as_dict()
        # fleet dedup-fabric seed (docs/dedup-fabric.md): when any tree edge
        # deduplicates, every gateway in the plan is a candidate segment
        # owner on the consistent-hash ring. The provisioner resolves member
        # urls once IPs exist and renders this into each VM's
        # SKYPLANE_TPU_FABRIC env; seats start as the gateway ids so a
        # replacement VM can adopt its predecessor's ring position.
        if any(d.get("dedup") for d in self.codec_decisions.values()):
            plan.metadata["fabric"] = {
                "members": [{"id": gid, "seat": gid} for gid in sorted(gw_by_id)],
                "draining": [],
            }
        return plan

    def _sink_dedup(self, tree: BlastTree, gw, estimate) -> bool:
        """A sink builds a SegmentStore when its INBOUND edge deduplicates."""
        parent = tree.parent[gw.gateway_id]
        _, dedup = self._edge_codec(tree.regions[parent], gw.region_tag, estimate)
        return dedup

    def _add_sends(self, program, parent_h, partition, from_region, children, gw_by_id, estimate, peer_serve):
        cfg = self.transfer_config
        send_parent = parent_h
        if len(children) > 1 and not peer_serve:
            # multicast: EVERY child gets every chunk (mux_and replication);
            # peer-serve sinks already hang their sends off the shared
            # mux_and that also feeds the write operator
            send_parent = program.add_operator(GatewayMuxAnd(), parent_handle=parent_h, partition_id=partition)
        conns = max(1, cfg.num_connections // max(1, len(children)))
        for child_id in children:
            child = gw_by_id[child_id]
            codec, dedup = self._edge_codec(from_region, child.region_tag, estimate)
            program.add_operator(
                GatewaySend(
                    target_gateway_id=child_id,
                    region=child.region_tag,
                    num_connections=conns,
                    compress=codec,
                    encrypt=cfg.encrypt_e2e,
                    dedup=dedup,
                    peer_serve=peer_serve,
                    # interior edges re-serve landed chunks: raw-forward the
                    # sealed frames unless the edge deduplicates (recipes
                    # depend on per-edge index state, never raw-eligible)
                    raw_eligible=(not dedup) if peer_serve else None,
                    private_ip=(from_region.split(":")[0] == child.region_tag.split(":")[0] == "gcp"),
                ),
                parent_handle=send_parent,
                partition_id=partition,
            )


# ---- loopback program builder (soak_blast.py, bench.py, the tier-1 test) ----


def build_local_blast_programs(
    tree: BlastTree,
    out_roots: Dict[str, str],
    num_connections: int = 2,
    compress: str = "none",
    dedup: bool = False,
    encrypt: bool = False,
) -> Dict[str, dict]:
    """Per-node gateway-program dicts for a loopback blast fleet: the source
    reads local files and sends to its tree children; every sink receives,
    writes under its own ``out_roots[node]`` (write_local path re-anchoring),
    and — when interior — peer-serves its children. Same operator shapes and
    connections the cloud planner emits (``num_connections`` is a gateway's,
    divided across its children as ``BlastPlanner._add_sends`` divides it),
    with local read/write endpoints."""
    programs: Dict[str, dict] = {}

    def send_op(target: str, peer: bool) -> dict:
        n_siblings = len(tree.children(tree.parent[target]))
        return {
            "op_type": "send",
            "handle": f"send_{target}",
            "target_gateway_id": target,
            "region": tree.regions[target],
            "num_connections": max(1, num_connections // n_siblings),
            "compress": compress,
            "encrypt": encrypt,
            "dedup": dedup,
            "peer_serve": peer,
            "raw_eligible": (not dedup) if peer else None,
            "children": [],
        }

    src_children = tree.children(tree.root)
    read: dict = {
        "op_type": "read_local",
        "handle": "read",
        "num_connections": num_connections,
        "children": [],
    }
    if len(src_children) == 1:
        read["children"] = [send_op(src_children[0], peer=False)]
    else:
        read["children"] = [
            {"op_type": "mux_and", "handle": "mux", "children": [send_op(c, peer=False) for c in src_children]}
        ]
    programs[tree.root] = {"plan": [{"partitions": ["default"], "value": [read]}]}

    for node in tree.sinks():
        children = tree.children(node)
        write = {"op_type": "write_local", "handle": "write", "path": out_roots[node], "children": []}
        if children:
            branches = [write] + [send_op(c, peer=True) for c in children]
            recv_children: List[dict] = [{"op_type": "mux_and", "handle": "mux", "children": branches}]
        else:
            recv_children = [write]
        programs[node] = {
            "plan": [
                {
                    "partitions": ["default"],
                    "value": [
                        {
                            "op_type": "receive",
                            "handle": "recv",
                            "decrypt": encrypt,
                            "dedup": dedup,
                            "children": recv_children,
                        }
                    ],
                }
            ]
        }
    return programs


def gateway_info_for(tree: BlastTree, control_ports: Dict[str, int], host: str = "127.0.0.1") -> Dict[str, Dict[str, dict]]:
    """Per-node gateway-info maps for a loopback fleet: each node needs the
    address of every tree CHILD it dials (parents dial children)."""
    infos: Dict[str, Dict[str, dict]] = {}
    for node in [tree.root] + tree.sinks():
        infos[node] = {
            child: {"public_ip": host, "control_port": control_ports[child]} for child in tree.children(node)
        }
    return infos


def start_order(tree: BlastTree) -> List[str]:
    """Leaves-first daemon start order (a parent's info map needs its
    children's control ports before it boots)."""
    order: List[str] = []
    seen = set()

    def visit(node: str) -> None:
        for child in tree.children(node):
            visit(child)
        if node not in seen:
            seen.add(node)
            order.append(node)

    visit(tree.root)
    return order
