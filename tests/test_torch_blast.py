"""The port's checkpoint blast (``skyplane_tpu_torch/blast``) against the JAX
package's, on the CPU.

Twins of ``tests/unit/test_blast_tree.py`` and
``tests/integration/test_blast.py`` run on the port (port daemons on the CPU).
Then the two packages are held against each other: the trees both solvers
place, the plans and codec decisions ``BlastPlanner`` emits and the loopback
programs ``build_local_blast_programs`` builds are equal as JSON; a blast over
a tree whose nodes mix the two packages' daemons lands byte-identical files;
and ``SkyplaneClient.pipeline(planning_algorithm="blast")`` over three
``local:`` sites gives equal trees and byte-identical files in both packages.

Inputs come from numpy seeds. Every comparison is exact, apart from the
solvers' costs, which the JAX tests hold to ``pytest.approx``.
"""

from __future__ import annotations

import copy
import hashlib
import importlib
import importlib.util
import json
import subprocess
import sys
import uuid
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from skyplane_tpu_torch.blast import (
    BlastController,
    BlastPlanner,
    BlastTree,
    build_local_blast_programs,
    parse_egress_edges,
    solve_blast_tree,
    solve_blast_tree_greedy,
    solve_blast_tree_milp,
    start_order,
    tree_cost_per_gb,
    validate_tree,
)
from skyplane_tpu_torch.obs import get_registry
from skyplane_tpu_torch.obs.events import EV_PLANNER_DOWNGRADE, configure_recorder
from skyplane_tpu_torch.planner.planner import OverlayPlanner, get_planner
from skyplane_tpu_torch.planner.pricing import get_egress_cost_per_gb
from tests.torch_gateway_util import hard_kill, jax_native_build_dir, start_blast_fleet, start_gateway  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
_ROOTS = {"port": "skyplane_tpu_torch", "ref": "skyplane_tpu"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{_ROOTS[pkg]}.{name}")


def _iface(region, bucket="b"):
    return SimpleNamespace(region_tag=lambda: region, bucket=lambda: bucket)


def _job(src_region, dst_regions):
    return SimpleNamespace(
        uuid=uuid.uuid4().hex,
        src_iface=_iface(src_region, "srcb"),
        dst_ifaces=[_iface(r, f"dst{i}") for i, r in enumerate(dst_regions)],
    )


def _cfg(pkg="port", **kw):
    defaults = dict(compress="none", dedup=False, encrypt_e2e=False, auto_codec_decision=False)
    defaults.update(kw)
    return _mod(pkg, "api.config").TransferConfig(**defaults)


SINKS8 = {f"s{i}": "local:local" for i in range(8)}
WAN_SINKS = {
    "a": "gcp:us-central1",
    "b": "gcp:europe-west1",
    "c": "gcp:asia-east1",
    "d": "aws:us-west-2",
}


# ---- twins of tests/unit/test_blast_tree.py ----


@pytest.mark.parametrize("solver", ["greedy", "milp"])
def test_tree_shape_invariants(solver):
    tree = solve_blast_tree(
        "src", SINKS8, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1, solver=solver
    )
    validate_tree(tree)
    assert sorted(tree.parent) == sorted(SINKS8)
    assert "src" not in tree.parent
    assert len(tree.children("src")) == 1
    assert all(len(tree.children(s)) <= 2 for s in tree.sinks())
    for s in tree.sinks():
        assert tree.path_from_root(s)[0] == "src"
    assert sum(tree.depth(s) for s in tree.sinks()) == 21


def test_tree_deterministic():
    a = solve_blast_tree_greedy("src", SINKS8, "local:local", cost_fn=lambda x, y: 0.0, fanout=3)
    b = solve_blast_tree_greedy("src", SINKS8, "local:local", cost_fn=lambda x, y: 0.0, fanout=3)
    assert a.edges() == b.edges()


def test_validate_tree_rejects_bad_shapes():
    regions = {"src": "r", "a": "r", "b": "r"}
    with pytest.raises(ValueError, match="cycle"):
        validate_tree(BlastTree(root="src", parent={"a": "b", "b": "a"}, regions=regions))
    with pytest.raises(ValueError, match="out-degree"):
        validate_tree(
            BlastTree(root="src", parent={"a": "src", "b": "src"}, regions=regions, source_degree=1, fanout=2)
        )
    with pytest.raises(ValueError, match="unknown node"):
        validate_tree(BlastTree(root="src", parent={"a": "ghost"}, regions={"src": "r", "a": "r"}))


def test_replace_node_rewires_parent_and_children():
    tree = solve_blast_tree_greedy("src", SINKS8, "local:local", cost_fn=lambda x, y: 0.0, fanout=2)
    victim = tree.children("src")[0]
    kids = tree.children(victim)
    tree.replace_node(victim, "repl")
    validate_tree(tree)
    assert tree.parent["repl"] == "src"
    assert all(tree.parent[k] == "repl" for k in kids)
    assert victim not in tree.parent and victim not in tree.regions


def test_edge_costs_match_grid():
    tree = solve_blast_tree("src", WAN_SINKS, "aws:us-east-1", fanout=3, source_degree=1)
    validate_tree(tree)
    expect = sum(get_egress_cost_per_gb(tree.regions[p], tree.regions[c]) for p, c in tree.edges())
    assert tree.cost_per_gb == pytest.approx(expect)
    assert tree.cost_per_gb == pytest.approx(tree_cost_per_gb(tree.edges(), tree.regions, get_egress_cost_per_gb))


def test_milp_vs_direct_cost_crossover():
    tree = solve_blast_tree("src", WAN_SINKS, "aws:us-east-1", fanout=3, source_degree=3)
    direct = sum(get_egress_cost_per_gb("aws:us-east-1", r) for r in WAN_SINKS.values())
    assert tree.cost_per_gb < direct
    assert (direct - tree.cost_per_gb) * 1000 > 10.0

    def star_costs(a, b):
        return 0.01 if a == "aws:us-east-1" else 1.0

    star = solve_blast_tree("src", WAN_SINKS, "aws:us-east-1", cost_fn=star_costs, fanout=3, source_degree=4)
    assert all(p == "src" for p, _ in star.edges())
    assert star.cost_per_gb == pytest.approx(0.04)


def test_milp_matches_or_beats_greedy_on_grid():
    milp = solve_blast_tree_milp("src", WAN_SINKS, "aws:us-east-1", fanout=2, source_degree=1)
    greedy = solve_blast_tree_greedy("src", WAN_SINKS, "aws:us-east-1", fanout=2, source_degree=1)
    if milp is None:
        pytest.skip("scipy.optimize.milp unavailable")
    assert milp.cost_per_gb <= greedy.cost_per_gb + 1e-9


def test_blast_plan_fanout_shapes():
    regions = [f"test:r{i}" for i in range(8)]
    job = _job("test:src", regions)
    planner = BlastPlanner(_cfg(), fanout=2, source_degree=1, quota_limits_file="")
    plan = planner.plan([job])
    assert plan.planner_name == "blast_tree"
    assert plan.metadata["tree"]["solver"] in ("milp", "greedy")
    sinks = {g.gateway_id for g in plan.sink_gateways()}
    assert len(sinks) == 8
    inbound: dict = {}
    for gid in plan.gateways:
        for tgt in plan.get_outgoing_paths(gid):
            inbound.setdefault(tgt, []).append(gid)
    assert sorted(inbound) == sorted(sinks)
    assert all(len(v) == 1 for v in inbound.values())
    seen, frontier = set(), [plan.source_gateways()[0].gateway_id]
    while frontier:
        gid = frontier.pop()
        for tgt in plan.get_outgoing_paths(gid):
            assert tgt not in seen, "cycle or double-visit in the blast program graph"
            seen.add(tgt)
            frontier.append(tgt)
    assert seen == sinks
    assert len(plan.get_outgoing_paths(plan.source_gateways()[0].gateway_id)) == 1
    assert plan.cost_per_gb == pytest.approx(plan.metadata["tree"]["cost_per_gb"], abs=1e-6)
    src_id = plan.source_gateways()[0].gateway_id
    for gid, gw in plan.gateways.items():
        def walk(ops):
            for op in ops:
                if op["op_type"] == "send":
                    assert op["peer_serve"] == (gid != src_id), (gid, op)
                walk(op.get("children", []))
        walk(gw.program_ops())
    for gid in sinks:
        assert plan.gateways[gid]._has_op("write_object_store")


def test_local_program_builder_shapes():
    tree = solve_blast_tree("src", SINKS8, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1)
    roots = {s: f"/tmp/out/{s}" for s in SINKS8}
    programs = build_local_blast_programs(tree, roots)
    assert sorted(programs) == sorted(["src"] + list(SINKS8))
    order = start_order(tree)
    for node in tree.sinks():
        assert order.index(node) < order.index(tree.parent[node])
    for node in tree.interior_nodes():
        recv = programs[node]["plan"][0]["value"][0]
        assert recv["op_type"] == "receive"
        mux = recv["children"][0]
        assert mux["op_type"] == "mux_and"
        kinds = sorted(c["op_type"] for c in mux["children"])
        assert kinds == sorted(["write_local"] + ["send"] * len(tree.children(node)))
        assert all(c.get("peer_serve") for c in mux["children"] if c["op_type"] == "send")


def _downgrade_counter():
    return get_registry().counter("planner_downgrades_total").value()


def test_overlay_multi_destination_downgrade_accounted():
    rec = configure_recorder(capacity=64)
    before = _downgrade_counter()
    planner = OverlayPlanner(_cfg(), solver="ron", candidate_regions=["test:c"], quota_limits_file="")
    plan = planner.plan([_job("test:src", ["test:r1", "test:r2"])])
    assert plan.planner_name == "multicast_direct"
    assert plan.metadata["downgraded_from"] == "overlay_ron"
    assert plan.metadata["downgrade_reason"] == "multi_destination"
    assert _downgrade_counter() == before + 1
    events = [e for e in rec.events_since(0) if e["kind"] == EV_PLANNER_DOWNGRADE]
    assert events and events[-1]["reason"] == "multi_destination"
    assert events[-1]["requested"] == "overlay_ron"
    configure_recorder()


def test_blast_single_destination_downgrade_accounted():
    rec = configure_recorder(capacity=64)
    before = _downgrade_counter()
    planner = get_planner("blast", _cfg(), quota_limits_file="")
    assert isinstance(planner, BlastPlanner)
    plan = planner.plan([_job("test:src", ["test:r1"])])
    assert plan.planner_name == "multicast_direct"
    assert plan.metadata["downgrade_reason"] == "single_destination"
    assert _downgrade_counter() == before + 1
    assert any(e["kind"] == EV_PLANNER_DOWNGRADE for e in rec.events_since(0))
    configure_recorder()


def test_overlay_no_candidates_downgrade_accounted():
    before = _downgrade_counter()
    planner = OverlayPlanner(_cfg(), solver="ron", candidate_regions=[], quota_limits_file="")
    plan = planner.plan([_job("test:src", ["test:r1"])])
    assert plan.planner_name == "multicast_direct"
    assert plan.metadata["downgrade_reason"] == "no_candidate_regions"
    assert _downgrade_counter() == before + 1


def test_parse_egress_edges():
    text = (
        "# HELP skyplane_egress_bytes_total per-src,dst value from the egress provider\n"
        "# TYPE skyplane_egress_bytes_total gauge\n"
        'skyplane_egress_bytes_total{src="gw_a",dst="gw_b"} 1048576\n'
        'skyplane_egress_bytes_total{src="gw_a",dst="gw_c"} 42\n'
        'skyplane_other_metric{src="x",dst="y"} 7\n'
    )
    assert parse_egress_edges(text) == {("gw_a", "gw_b"): 1048576, ("gw_a", "gw_c"): 42}


# ---- twins of tests/integration/test_blast.py, on port daemons on the CPU ----

rng = np.random.default_rng(61)


def _make_corpus(tmp: Path, n_bytes: int) -> bytes:
    payload = rng.integers(0, 256, n_bytes // 2, dtype=np.uint8).tobytes() + bytes(n_bytes - n_bytes // 2)
    (tmp / "ckpt.bin").write_bytes(payload)
    return payload


def _chunk_requests(src_path: Path, dst_path: str, chunk_bytes: int):
    from skyplane_tpu_torch.chunk import Chunk, ChunkRequest

    size, reqs = src_path.stat().st_size, []
    for off in range(0, size, chunk_bytes):
        chunk = Chunk(src_key=str(src_path), dest_key=dst_path, chunk_id=uuid.uuid4().hex,
                      chunk_length_bytes=min(chunk_bytes, size - off), file_offset_bytes=off)
        reqs.append(ChunkRequest(chunk=chunk, src_region="local:local", dst_region="local:local",
                                 src_type="local", dst_type="local"))
    return reqs


def _stop(*gws):
    for gw in gws:
        try:
            gw.stop()
        except Exception:  # noqa: BLE001 — a hard-killed daemon is already down
            pass


def test_blast_four_sinks_byte_identical_one_x_egress(tmp_path):
    sinks = {f"sink_{i}": "local:local" for i in range(4)}
    tree = solve_blast_tree("blast_src", sinks, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1)
    payload = _make_corpus(tmp_path, 3 << 20)
    source, sink_gws, out_roots = start_blast_fleet(tmp_path, tree, compress="none", dedup=False, encrypt=False)
    try:
        ctl = BlastController(source, sink_gws, tree, poll_s=0.1)
        reqs = _chunk_requests(tmp_path / "ckpt.bin", "/blast/ckpt.bin", 256 << 10)
        ctl.dispatch(reqs)
        progress = ctl.wait(timeout=120)
        assert all(n == len(reqs) for n in progress.values()), progress
        want = hashlib.md5(payload).hexdigest()
        for node, root in out_roots.items():
            got = (Path(root) / "blast/ckpt.bin").read_bytes()
            assert hashlib.md5(got).hexdigest() == want, f"sink {node} corrupt"
        assert ctl.sink_registration_duplicates() == 0
        egress = ctl.source_egress_bytes()
        ratio = egress / len(payload)
        assert 0.9 <= ratio <= 1.2, f"source egress ratio {ratio:.3f} (egress={egress})"
    finally:
        _stop(source, *sink_gws.values())


def _heal_run(tmp_path, n_bytes, chunk_bytes, registered_first=False, **codec):
    """Blast ``n_bytes`` to four sinks on a greedy tree, hard-kill the first
    relay once some but not all of its chunks are complete (and, with
    ``registered_first``, once every chunk is registered there), and let the
    controller heal it. Returns (controller, victim, payload, out_roots,
    duplicate registrations)."""
    sinks = {f"sink_{i}": "local:local" for i in range(4)}
    tree = solve_blast_tree(
        "blast_src", sinks, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1, solver="greedy"
    )
    victim = tree.children(tree.root)[0]
    payload = _make_corpus(tmp_path, n_bytes)
    source, sink_gws, out_roots = start_blast_fleet(tmp_path, tree, **codec)
    replacements = []

    def factory(dead):
        new_id = f"{dead}+r1"
        roots = dict(out_roots)
        roots[new_id] = roots[dead]
        t2 = copy.deepcopy(ctl.tree)
        t2.replace_node(dead, new_id)
        progs = build_local_blast_programs(t2, roots, num_connections=2, **codec)
        info = {c: {"public_ip": "127.0.0.1", "control_port": ctl.sinks[c].control_port} for c in t2.children(new_id)}
        gw = start_gateway("port", progs[new_id], info, new_id, tmp_path / f"{new_id}_chunks", use_tls=False)
        replacements.append(gw)
        return new_id, gw

    killed = {"done": False}

    def kill_check():
        if killed["done"]:
            return
        victim_done = len(ctl._complete.get(victim, ()))
        if not 0 < victim_done < len(reqs):
            return
        if registered_first and len(sink_gws[victim].get("chunk_requests", timeout=30).json()["chunk_requests"]) < len(reqs):
            return
        killed["done"] = True
        hard_kill(sink_gws[victim])

    try:
        ctl = BlastController(source, sink_gws, tree, poll_s=0.1, replacement_factory=factory)
        reqs = _chunk_requests(tmp_path / "ckpt.bin", "/blast/ckpt.bin", chunk_bytes)
        ctl.dispatch(reqs)
        ctl.wait(timeout=180, kill_check=kill_check)
        assert killed["done"], "kill never fired (blast finished too fast; shrink chunk size)"
        dups = ctl.sink_registration_duplicates()
    finally:
        _stop(source, *sink_gws.values(), *replacements)
    return ctl, victim, payload, out_roots, dups


def test_blast_relay_death_heals_mid_blast(tmp_path):
    """The relay dies mid-blast once every chunk is registered there (see the
    next test for why)."""
    ctl, victim, payload, out_roots, dups = _heal_run(tmp_path, 12 << 20, 128 << 10, registered_first=True,
                                                      compress="none", dedup=False)
    assert ctl.relays_died == [victim]
    assert ctl.replacements == [f"{victim}+r1"]
    assert ctl.retargeted_ops >= 1
    want = hashlib.md5(payload).hexdigest()
    for node in ctl.sinks:
        root = out_roots.get(node, out_roots[victim])
        got = (Path(root) / "blast/ckpt.bin").read_bytes()
        assert hashlib.md5(got).hexdigest() == want, f"sink {node} corrupt after heal"
    assert dups == 0


def test_blast_relay_death_heals_with_codec_tpu_and_dedup(tmp_path):
    """The heal at the codec of the card's blast: codec ``tpu`` with dedup on
    every edge, so the replacement starts with an empty segment store behind
    a parent whose index still holds the dead relay's segments. The relay
    dies after every chunk is registered there: a source whose registration
    POST to a dead relay outlasts its retry ladder (about 1.5 s) before the
    heal stops on that error, in both packages."""
    ctl, victim, payload, out_roots, dups = _heal_run(tmp_path, 6 << 20, 128 << 10, registered_first=True,
                                                      compress="tpu", dedup=True)
    assert ctl.relays_died == [victim] and ctl.replacements == [f"{victim}+r1"]
    for node in ctl.sinks:
        root = out_roots.get(node, out_roots[victim])
        assert (Path(root) / "blast/ckpt.bin").read_bytes() == payload, f"sink {node} corrupt after heal"
    assert dups == 0


# ---- the port against the JAX package ----

_TREE_CASES = [
    ("src", {f"s{i}": "local:local" for i in range(5)}, "local:local", "zero", 2, 1),
    ("src", {f"s{i}": "local:local" for i in range(6)}, "local:local", "zero", 3, 2),
    ("src", WAN_SINKS, "aws:us-east-1", "grid", 3, 1),
    ("src", WAN_SINKS, "aws:us-east-1", "grid", 2, 1),
    ("src", WAN_SINKS, "aws:us-east-1", "grid", 3, 3),
    ("src", WAN_SINKS, "aws:us-east-1", "star", 3, 4),
    ("root", {f"n{i}": r for i, r in enumerate(["aws:eu-west-1", "aws:us-east-1", "gcp:us-central1",
                                                   "azure:eastus", "aws:ap-south-1", "gcp:asia-east1"])},
     "gcp:europe-west1", "grid", 2, 1),
]


def _cost_fn(pkg, name):
    if name == "zero":
        return lambda a, b: 0.0
    if name == "star":
        return lambda a, b: 0.01 if a == "aws:us-east-1" else 1.0
    return _mod(pkg, "planner.pricing").get_egress_cost_per_gb


@pytest.mark.parametrize("solver", ["auto", "milp", "greedy"])
@pytest.mark.parametrize("case", range(len(_TREE_CASES)))
def test_trees_equal_the_jax_package(case, solver):
    root, sinks, root_region, cost, fanout, degree = _TREE_CASES[case]
    trees = {
        pkg: _mod(pkg, "blast.tree").solve_blast_tree(
            root, dict(sinks), root_region, cost_fn=_cost_fn(pkg, cost), fanout=fanout, source_degree=degree,
            solver=solver,
        ).as_dict()
        for pkg in ("port", "ref")
    }
    assert trees["port"] == trees["ref"]


def _plan_view(plan, planner, jobs) -> dict:
    text = json.dumps({
        "programs": {gid: gw.gateway_program.to_dict() for gid, gw in plan.gateways.items()},
        "gateways": {gid: [gw.region_tag, gw.vm_type] for gid, gw in plan.gateways.items()},
        "info": plan.get_gateway_info_json(),
        "cost_per_gb": plan.cost_per_gb,
        "planner": plan.planner_name,
        "metadata": plan.metadata,
        "codec_decisions": {f"{a}->{b}": d for (a, b), d in sorted(getattr(plan, "codec_decisions", {}).items())},
        "planner_decisions": {f"{a}->{b}": d for (a, b), d in sorted(planner.codec_decisions.items())},
        "sources": [g.gateway_id for g in plan.source_gateways()],
        "sinks": [g.gateway_id for g in plan.sink_gateways()],
    }, sort_keys=True, default=str)
    for i, j in enumerate(jobs):
        text = text.replace(j.uuid, f"JOB{i}")
    return json.loads(text)


def _corpus(root, seed: int = 5):
    rng_c = np.random.default_rng(seed)
    block = rng_c.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    root.mkdir(parents=True, exist_ok=True)
    for i in range(3):
        noise = rng_c.integers(0, 256, 8192 * (i + 1), dtype=np.uint8).tobytes()
        (root / f"f{i}.bin").write_bytes(block * 16 + bytes(20000) + noise + block * 4)


def _posix_job(pkg, tmp, src_tag, dst_tags):
    tj = _mod(pkg, "api.transfer_job")
    posix = _mod(pkg, "obj_store.posix_file_interface")
    j = tj.CopyJob("local:///", ["local:///"] * len(dst_tags), recursive=True)
    j._src_iface = posix.POSIXInterface(str(tmp / "src"), region_tag=src_tag)
    j._dst_ifaces = [posix.POSIXInterface(str(tmp / f"dst{i}"), region_tag=t) for i, t in enumerate(dst_tags)]
    j.src_path, j.dst_paths = "local:///", ["local:///"] * len(dst_tags)
    return j


_PLAN_CASES = [
    ("local:siteA", ["local:siteB", "local:siteC", "local:siteD"], {"compress": "tpu", "dedup": True}, {}),
    ("local:siteA", ["local:siteB", "local:siteC", "local:siteD", "local:siteE"],
     {"compress": "tpu", "dedup": True, "auto_codec_decision": True}, {}),
    ("aws:us-east-1", list(WAN_SINKS.values()), {"compress": "none", "encrypt_e2e": True}, {"fanout": 2}),
    ("aws:us-east-1", list(WAN_SINKS.values()) + ["gcp:us-central1"],
     {"compress": "tpu", "dedup": True, "auto_codec_decision": True, "num_connections": 8},
     {"source_degree": 2, "tree_solver": "greedy"}),
    ("gcp:us-central1", ["gcp:europe-west1", "gcp:asia-east1"], {"compress": "native_lz"}, {}),
    ("local:siteA", ["local:siteB"], {"compress": "tpu", "dedup": True}, {}),
]


@pytest.mark.parametrize("case", range(len(_PLAN_CASES)))
def test_blast_plan_equals_the_jax_package(tmp_path, case):
    src_tag, dst_tags, cfg_kw, planner_kw = _PLAN_CASES[case]
    _corpus(tmp_path / "src")
    views = {}
    for pkg in ("port", "ref"):
        jobs = [_posix_job(pkg, tmp_path, src_tag, dst_tags)]
        planner = _mod(pkg, "planner.planner").get_planner("blast", _cfg(pkg, **cfg_kw), quota_limits_file="",
                                                          **planner_kw)
        assert type(planner).__module__ == f"{_ROOTS[pkg]}.blast.planner"
        plan = planner.plan(jobs)
        views[pkg] = _plan_view(plan, planner, jobs)
    assert views["port"] == views["ref"]


@pytest.mark.parametrize("kw", [
    {},
    {"compress": "tpu", "dedup": True, "num_connections": 4},
    {"compress": "native_lz", "encrypt": True, "num_connections": 1},
])
@pytest.mark.parametrize("fanout", [1, 2, 3])
def test_local_blast_programs_equal_the_jax_package(kw, fanout):
    """Equal but for the connections of each send: the port divides a
    gateway's ``num_connections`` across its children as the planner does,
    where the JAX package's ``build_local_blast_programs`` gives every edge
    all of them."""
    got = {}
    for pkg in ("port", "ref"):
        tree_mod = _mod(pkg, "blast.tree")
        planner_mod = _mod(pkg, "blast.planner")
        tree = tree_mod.solve_blast_tree_greedy("src", dict(SINKS8), "local:local", cost_fn=lambda a, b: 0.0,
                                                fanout=fanout, source_degree=1 if fanout < 3 else 2)
        roots = {s: f"/out/{s}" for s in SINKS8}
        ports = {n: 9000 + i for i, n in enumerate(sorted([tree.root] + tree.sinks()))}
        got[pkg] = {
            "programs": planner_mod.build_local_blast_programs(tree, roots, **kw),
            "infos": planner_mod.gateway_info_for(tree, ports),
            "order": planner_mod.start_order(tree),
        }
    n = kw.get("num_connections", 2)
    for node, prog in got["ref"]["programs"].items():
        for op in _walk_ops(prog["plan"][0]["value"]):
            if op["op_type"] == "send":
                op["num_connections"] = max(1, n // len(tree.children(node)))
    assert got["port"] == got["ref"]


def _walk_ops(ops):
    for op in ops:
        yield op
        yield from _walk_ops(op.get("children", []))


@pytest.mark.parametrize("mix", ["port_source_ref_relay", "ref_source_port_relay"])
def test_mixed_package_blast_tree(tmp_path, mix):
    """One blast over a tree whose nodes mix the packages: a port source, a
    JAX relay peer-serving port sinks (or a JAX source, the rest port), codec
    ``tpu`` with dedup on every edge."""
    sinks = {f"sink_{i}": "local:local" for i in range(3)}
    tree = solve_blast_tree("blast_src", sinks, "local:local", cost_fn=lambda a, b: 0.0, fanout=2, source_degree=1)
    pkg_of = {n: "port" for n in [tree.root] + tree.sinks()}
    pkg_of[tree.interior_nodes()[0] if mix == "port_source_ref_relay" else tree.root] = "ref"
    payload = _make_corpus(tmp_path, 1 << 20)
    source, sink_gws, out_roots = start_blast_fleet(tmp_path, tree, pkg=pkg_of, compress="tpu", dedup=True)
    try:
        ctl = BlastController(source, sink_gws, tree, poll_s=0.05)
        ctl.dispatch(_chunk_requests(tmp_path / "ckpt.bin", "/blast/ckpt.bin", 128 << 10))
        ctl.wait(timeout=120)
        for node, root in out_roots.items():
            assert (Path(root) / "blast/ckpt.bin").read_bytes() == payload, f"sink {node} ({pkg_of[node]}) differs"
        assert ctl.sink_registration_duplicates() == 0
    finally:
        _stop(source, *sink_gws.values())


def _blast_pipeline(pkg, root: Path, data: dict, sites):
    posix = _mod(pkg, "obj_store.posix_file_interface")
    cfg = _mod(pkg, "api.config").TransferConfig(compress="tpu", dedup=True, auto_codec_decision=False,
                                                 encrypt_e2e=False, encrypt_socket_tls=False)
    client = _mod(pkg, "api.client").SkyplaneClient(transfer_config=cfg, log_dir=str(root / "log"))
    pipe = client.pipeline(planning_algorithm="blast")
    job = _mod(pkg, "api.transfer_job").CopyJob("local:///", ["local:///"] * len(sites), recursive=True)
    job._src_iface = posix.POSIXInterface(str(root / "siteA"), region_tag="local:siteA")
    job._dst_ifaces = [posix.POSIXInterface(str(root / s), region_tag=f"local:{s}") for s in sites]
    job.src_path, job.dst_paths = "local:///", ["local:///"] * len(sites)
    pipe.jobs_to_dispatch.append(job)
    kept = {}
    create_dataplane = pipe.create_dataplane

    def keep(debug=False):
        kept["dp"] = create_dataplane(debug)
        return kept["dp"]

    pipe.create_dataplane = keep
    stats = pipe.start()
    for s in sites:
        for name, payload in data.items():
            assert (root / s / name).read_bytes() == payload, (pkg, s, name)
    assert stats["logical_bytes"] == sum(map(len, data.values()))
    return kept["dp"].topology.metadata["tree"]


def test_pipeline_blast_equals_the_jax_package(tmp_path, monkeypatch):
    """``pipeline(planning_algorithm="blast")`` over three ``local:`` sites in
    both packages, their daemons on the CPU: equal trees, every file
    byte-identical at every site."""
    monkeypatch.setenv("SKYPLANE_LOCAL_GATEWAY_PLATFORM", "cpu")
    rng_p = np.random.default_rng(62)
    data = {f"f{i}.bin": rng_p.integers(0, 256, n, dtype=np.uint8).tobytes() for i, n in enumerate([150_000, 90_000])}
    sites = ["siteB", "siteC", "siteD"]
    trees = {}
    for pkg in ("port", "ref"):
        root = tmp_path / pkg
        monkeypatch.setenv("SKYPLANE_TPU_FLEET_DIR", str(root / "fleet"))
        (root / "siteA").mkdir(parents=True)
        for s in sites:
            (root / s).mkdir()
        for name, payload in data.items():
            (root / "siteA" / name).write_bytes(payload)
        trees[pkg] = _blast_pipeline(pkg, root, data, sites)
    assert trees["port"] == trees["ref"]
    assert trees["port"]["solver"] == "milp" and trees["port"]["source_degree"] == 1


def test_blast_and_service_import_no_jax():
    """In a fresh process: the blast planner plans through ``get_planner``, a
    tree is solved by the MILP, a controller and a service controller (over a
    WAL) are built, with neither jax, the JAX package nor ``requests``
    imported."""
    code = (
        "import sys, tempfile, types, uuid\n"
        "import skyplane_tpu_torch.blast, skyplane_tpu_torch.service\n"
        "from skyplane_tpu_torch.service import worker, api\n"
        "from skyplane_tpu_torch.api.config import TransferConfig\n"
        "from skyplane_tpu_torch.planner.planner import get_planner\n"
        "from skyplane_tpu_torch.blast import BlastController, solve_blast_tree\n"
        "from skyplane_tpu_torch.api.client import SkyplaneClient\n"
        "iface = lambda r: types.SimpleNamespace(region_tag=lambda: r, bucket=lambda: 'b')\n"
        "job = types.SimpleNamespace(uuid=uuid.uuid4().hex, src_iface=iface('local:a'),\n"
        "                            dst_ifaces=[iface('local:b'), iface('local:c'), iface('local:d')])\n"
        "cfg = TransferConfig(auto_codec_decision=False)\n"
        "plan = get_planner('blast', cfg, quota_limits_file='').plan([job])\n"
        "assert plan.planner_name == 'blast_tree' and plan.metadata['tree']['solver'] == 'milp'\n"
        "tree = solve_blast_tree('s', {'a': 'x', 'b': 'y'}, 'z', cost_fn=lambda a, b: 0.0)\n"
        "BlastController(None, {}, tree)\n"
        "d = tempfile.mkdtemp()\n"
        "c = SkyplaneClient(log_dir=d + '/log').service(d + '/wal', 'http://127.0.0.1:1', 'http://127.0.0.1:2')\n"
        "assert type(c).__module__ == 'skyplane_tpu_torch.service.controller'\n"
        "c.close()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'skyplane_tpu', 'requests'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---- every copied module keeps the reference's names ----

_COPIED = ["blast", "blast.tree", "blast.planner", "blast.controller"]
_ADDED = {"blast.controller": {"ControlRequestError"}}


def _names(mod):
    return {n for n, v in vars(mod).items() if not n.startswith("__") and not isinstance(v, type(json))}


@pytest.mark.parametrize("name", _COPIED)
def test_copied_module_keeps_the_reference_names(name):
    port, ref = _mod("port", name), _mod("ref", name)
    pn, rn = _names(port), _names(ref)
    assert pn - rn <= _ADDED.get(name, set()), f"added: {sorted(pn - rn)}"
    assert rn - pn == set(), f"missing: {sorted(rn - pn)}"
    if hasattr(ref, "__all__"):
        assert port.__all__ == ref.__all__


# ---- the plain reference of port_bench, and the planner's connections ----


def _tree_ref():
    spec = importlib.util.spec_from_file_location("blast_tree_ref", REPO / "port_bench/reference/blast_tree_ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(seed: int, k: int):
    """A seeded cost grid over a source region and ``k`` sink regions, drawn
    from a few egress prices so that equal-cost trees are common; or, at
    seed -1, every edge free (a loopback)."""
    regions = ["r_src"] + [f"r{i}" for i in range(k)]
    rng = np.random.default_rng(max(seed, 0))
    prices = [0.0, 0.01, 0.02, 0.05, 0.08, 0.09, 0.12]
    grid = {(a, b): (0.0 if seed < 0 else float(rng.choice(prices))) for a in regions for b in regions}
    fanout, degree = (3, 1) if seed < 0 else (int(rng.integers(1, 4)), int(rng.integers(1, 3)))
    return {f"s{i}": f"r{i}" for i in range(k)}, (lambda a, b: grid[(a, b)]), fanout, degree


@pytest.mark.parametrize("seed", [-1, *range(8)], ids=["zero", *map(str, range(8))])
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_tree_solvers_equal_the_plain_reference(k, seed):
    """Both solvers place a tree within the degree bounds. At zero costs (the
    loopback, where the MILP weighs depth alone) each has the reference's
    cost and total depth. On priced grids the MILP has the reference's
    least cost; its depth tie-break sits below the solver's gap, so its
    depth is not held (an inherited gap, ROADMAP queue 1). The greedy rung,
    a heuristic, has no less than the reference's cost there."""
    ref = _tree_ref()
    sinks, cost_fn, fanout, degree = _grid(seed, k)
    want = ref.best_tree("src", sinks, "r_src", cost_fn, fanout, degree)
    for solver in ("milp", "greedy"):
        tree = solve_blast_tree("src", sinks, "r_src", cost_fn=cost_fn, fanout=fanout, source_degree=degree,
                                solver=solver)
        assert tree.solver == solver and sorted(tree.parent) == sorted(sinks)
        assert ref.within_bounds("src", tree.parent, fanout, degree)
        cost, depth = ref.score("src", tree.parent, tree.regions, cost_fn)
        assert depth == sum(tree.depth(s) for s in tree.sinks())
        if seed < 0:
            assert (cost, depth) == pytest.approx((want.cost, want.depth), abs=1e-12), (solver, tree.edges(), want)
        elif solver == "milp":
            assert cost == pytest.approx(want.cost, abs=1e-12), (tree.edges(), want)
        else:
            assert cost >= want.cost - 1e-12


def test_tree_reference_imports_nothing_but_the_standard_library():
    import ast

    tree = ast.parse((REPO / "port_bench/reference/blast_tree_ref.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in mods} <= {"__future__", "collections", "itertools", "typing"}


@pytest.mark.parametrize("n_dst,fanout,degree,conns", [(4, 3, 1, 32), (8, 2, 1, 32), (6, 3, 2, 7), (3, 3, 1, 2)])
def test_local_blast_programs_take_the_planners_connections(n_dst, fanout, degree, conns):
    """``build_local_blast_programs`` gives each send the connections the planner's
    ``_add_sends`` gives it: the gateway's count divided across its
    children; the source's read keeps the whole count."""
    dsts = [f"local:site{i}" for i in range(n_dst)]
    planner = BlastPlanner(_cfg(compress="tpu", dedup=True, num_connections=conns), fanout=fanout,
                           source_degree=degree, quota_limits_file="")
    plan = planner.plan([_job("local:src", dsts)])
    tree = planner.last_tree
    planned = {}
    for gid, gw in plan.gateways.items():
        for op in _walk_ops(gw.gateway_program.to_dict()["plan"][0]["value"]):
            if op["op_type"] == "send":
                planned[(gid, op["target_gateway_id"])] = op["num_connections"]
    assert sorted(planned) == sorted(tree.edges())
    programs = build_local_blast_programs(tree, {s: f"/out/{s}" for s in tree.sinks()}, num_connections=conns,
                                          compress="tpu", dedup=True)
    local = {}
    for node, prog in programs.items():
        for op in _walk_ops(prog["plan"][0]["value"]):
            if op["op_type"] == "send":
                local[(node, op["target_gateway_id"])] = op["num_connections"]
            if op["op_type"] == "read_local":
                assert op["num_connections"] == conns
    assert local == planned
    assert any(len(tree.children(s)) > 1 for s in tree.sinks())  # a divided count is checked
