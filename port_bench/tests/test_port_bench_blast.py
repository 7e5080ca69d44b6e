"""The blast configuration and its fleet: the plain reference of the tree,
the fleet's tree held to it, the fleet's refusals, and a whole run of the
blast cell at a tiny size on the CPU (run from the repository root:
``python -m pytest port_bench/tests -q``)."""

import ast
import contextlib
import importlib.util
import io
import json

import pytest

from conftest import BENCH_DIR, TINY_MIX

from reference import blast_tree_ref

CELL = "blast4.snapchain.bulk"
CONFIG = BENCH_DIR / "configs" / "blast4_dedup.json"


def blast_fleet(name: str = "blast_fleet_under_test"):
    spec = importlib.util.spec_from_file_location(name, BENCH_DIR / "fleets" / "blast_fleet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_blast_cell(seed: int, trace: int, seconds: int) -> tuple:
    """``main`` of the harness in this process on the CPU at a tiny size,
    with a disk budget for four sinks (six objects): (exit code, the result
    line's JSON or None, standard error)."""
    from pbench.harness import main

    override = json.dumps({"mix": dict(TINY_MIX, disk_budget_bytes=32 << 20)})
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
                   "--device", "cpu", "--override", override])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("fanout,source_degree,depth", [(3, 1, 7), (1, 1, 10), (2, 2, 6), (3, 4, 4)])
def test_tree_reference_finds_the_shallowest_tree_on_a_loopback(fanout, source_degree, depth):
    sinks = {f"s{i}": "local:x" for i in range(4)}
    best = blast_tree_ref.best_tree("src", sinks, "local:a", lambda a, b: 0.0, fanout, source_degree)
    assert best.cost == 0.0 and best.depth == depth
    assert blast_tree_ref.within_bounds("src", best.parent, fanout, source_degree)


def test_reference_of_the_tree_imports_nothing_of_the_program():
    tree = ast.parse((BENCH_DIR / "reference" / "blast_tree_ref.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in mods} <= {"__future__", "collections", "itertools", "typing"}


def test_fleet_bounds_are_the_planners_defaults():
    """The configuration states the tree's bounds under ``assumed`` as the
    blast planner's defaults; the fleet runs them."""
    from skyplane_tpu_torch.blast.tree import DEFAULT_FANOUT, DEFAULT_SOURCE_DEGREE

    fleet = blast_fleet()
    assumed = json.loads(CONFIG.read_text())["assumed"]
    assert (fleet.FANOUT, fleet.SOURCE_DEGREE) == (DEFAULT_FANOUT, DEFAULT_SOURCE_DEGREE) == (3, 1)
    assert assumed["fanout"].startswith("3,") and assumed["source_degree"].startswith("1,")


def test_blast_fleet_runs_the_reference_tree_and_refuses_another(monkeypatch):
    """The blast configuration's tree is one relay under the source with
    the three leaves under it; a solver that placed a deeper tree is refused
    before any daemon starts."""
    import skyplane_tpu_torch.blast as blast

    fleet = blast_fleet()
    cfg = json.loads(CONFIG.read_text())
    tree = fleet.solve(cfg)
    (relay,) = tree.interior_nodes()
    assert tree.children("gw_src") == [relay] and len(tree.children(relay)) == 3
    chain_tree = fleet.solve(cfg, fanout=1)  # the other bounds the fleet takes are held to the reference too
    assert sum(chain_tree.depth(s) for s in chain_tree.sinks()) == 10
    chain = {"gw_sink0": "gw_src", "gw_sink1": "gw_sink0", "gw_sink2": "gw_sink1", "gw_sink3": "gw_sink2"}
    monkeypatch.setattr(blast, "solve_blast_tree", lambda *a, **k: blast.BlastTree(
        root="gw_src", parent=dict(chain), regions={"gw_src": "local:siteA", **{s: "local:x" for s in chain}}))
    with pytest.raises(ValueError, match="fanout/source_degree"):
        fleet.solve(cfg)


def test_blast_cell_is_correct_at_every_sink_and_reads_the_relay(monkeypatch):
    """The blast cell through src -> relay -> three leaves, the relay on the
    harness's device (the CPU here, with a runner of its own): every window
    chunk lands byte for byte at all four sinks, the source's recipes equal
    the reference's, and the relay's three readers find their counters."""
    monkeypatch.setenv("SKYPLANE_GATEWAY_DEVICE", "cpu")
    rc, result, err = run_blast_cell(seed=2**31 + 13, trace=1, seconds=4)
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, err[-3000:]
    relay = {k: v["value"] for k, v in result["metrics"].items() if k.startswith("relay.")}
    assert set(relay) == {"relay.forward_wait_ms_per_chunk", "relay.encode_ms_per_chunk", "relay.rows_per_window"}
    assert all(v > 0 for v in relay.values()), relay


def test_blast_fleet_refuses_a_harness_device_other_than_the_relays(monkeypatch, tmp_path):
    """A run whose harness device differs from the relay's
    ``SKYPLANE_GATEWAY_DEVICE`` stops before the source starts; a fleet
    whose source never ran is not held to the card's kernel launches."""
    import torch

    from pbench.fleet import e2ee_key

    mod = blast_fleet("blast_fleet_device")
    cfg = json.loads(CONFIG.read_text())
    monkeypatch.setenv("SKYPLANE_GATEWAY_DEVICE", "cuda")
    fleet = mod.Fleet(cfg, tmp_path, e2ee_key(7), 1)
    try:
        assert len(fleet.relays) == 1
        with pytest.raises(ValueError, match="SKYPLANE_GATEWAY_DEVICE=cuda"):
            fleet.start_source(torch.device("cpu"))
        assert fleet.source is None
        for leaf in set(fleet.sinks) - set(fleet.relays):  # up, so that each stops when asked
            leaf.wait_up(180, alive=lambda leaf=leaf: leaf.proc.poll() is None)
    finally:
        fleet.stop()
