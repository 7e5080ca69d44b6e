"""Every configuration, mix and metric that BENCHMARK.json names is a file of
its own, found by name; the file keeps to the benchmark's contract; every
key of a configuration is read, refused unless at the value the fleet
runs, or prose; a new cell is added by data alone, and a new deployment by
files alone."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT, TINY_MIX

from pbench.fleet import Fleet
from pbench.harness import fleet_class

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and b["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len(json.dumps(b).encode()) <= 64 << 10


def test_every_file_parses_and_is_found_by_name():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("port_bench/configs/")
        assert set(c["reduced"]) <= set(cfg["reduced_why"]) and set(c["reduced"]) <= set(cfg)
        assert (ROOT / cfg["reference"]).exists()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        json.loads((BENCH_DIR / "mixes" / f"{w['traffic']}.json").read_text())
    for m in b["end_to_end"] + b["per_layer"]:
        path = BENCH_DIR / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("metric_under_test", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_every_cell_reports_enough_and_each_layer_metric_its_end_to_end_metric():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if reports(m, w["name"])]
        assert any(m["name"] == "setup_s" for m in mine) and len(mine) >= 2
        assert any(reports(m, w["name"]) for m in b["per_layer"])
    for m in b["per_layer"]:
        for cell in m["workloads"]:
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_new_cell_is_data_only(tmp_path):
    """A copy of the benchmark gains a mix file and a cell entry, and runs
    that cell: no existing file of port_bench/ changes."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    mix = json.loads((BENCH_DIR / "mixes" / "snapchain.bulk.json").read_text())
    mix.update(TINY_MIX, write_site_frac=0.02)
    (tmp_path / "port_bench" / "mixes" / "snapchain.heavywrites.json").write_text(json.dumps(mix))
    b["workloads"].append({"name": "direct.snapchain.heavywrites", "config": "direct_dedup",
                           "traffic": "snapchain.heavywrites", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "direct.snapchain.bulk" in m.get("workloads", []):
            m["workloads"].append("direct.snapchain.heavywrites")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in BENCH_DIR.rglob("*") if p.is_file() and ".cache" not in p.parts
              and "__pycache__" not in p.parts}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "direct.snapchain.heavywrites", "--seed", "9",
                        "--seconds", "2", "--trace", "0", "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and {"goodput_gbps", "wire_reduction", "setup_s"} <= set(result["metrics"])
    assert all(p.read_bytes() == data for p, data in before.items())


# every top-level key of a configuration file: read by the harness or its
# fleet; refused by the star fleet unless at the value it runs; or
# prose for the reader
READ = {"sinks", "source_region", "sink_regions", "num_connections", "dedup", "codec", "encrypt_e2e",
        "encrypt_socket_tls", "batch_chunks", "multipart_chunk_size_mb", "cdc", "reference", "fleet"}
PROSE = {"deployment", "assumed", "reduced_why", "link", "placement", "corpus_bytes", "flags_source"}


def test_every_config_key_is_read_refused_or_prose():
    refused = set(Fleet.refused)
    sources = "".join(p.read_text() for p in (BENCH_DIR / "pbench").glob("*.py"))
    assert all(f'"{key}"' in sources for key in READ | refused)
    assert not (READ & PROSE or READ & refused or PROSE & refused)
    for c in bench()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg) <= READ | PROSE | refused, (c["name"], set(cfg) - READ - PROSE - refused)
        assert all(cfg.get(key, runs) == runs for key, runs in Fleet.refused.items())


@pytest.mark.parametrize("key,value", [("paranoid_verify", True), ("verify_checksums", False), ("max_instances", 2),
                                       ("multipart_chunk_size_mb", 0)])
def test_a_key_the_fleet_cannot_run_stops_the_run(key, value):
    """A configuration that states what the run cannot honour ends it with
    an error naming the key, before any daemon starts."""
    override = json.dumps({"config": {key: value}, "mix": TINY_MIX})
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "direct.snapchain.bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu", "--override", override],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert key in r.stderr.strip().splitlines()[-1], r.stderr[-2000:]


def test_a_config_without_a_fleet_key_runs_the_star_fleet():
    assert fleet_class({}) is Fleet
    other = fleet_class({"fleet": "port_bench/tests/two_hop_fleet.py"})
    assert other is not Fleet and issubclass(other, Fleet)


def test_a_new_deployment_is_files_only(tmp_path):
    """A copy of the benchmark gains a configuration whose ``fleet`` names
    the two-hop fleet of ``port_bench/tests/two_hop_fleet.py``, a mix, a
    metric reader of the fleet's own counter group, and entries; it runs
    that cell on the CPU: correct at both sinks, the reader's metric
    reported, and no existing file of port_bench/ changed."""
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    copy = tmp_path / "port_bench"
    b = bench()
    cfg = json.loads((BENCH_DIR / "configs" / "direct_dedup.json").read_text())
    cfg.update(sinks=2, sink_regions=["local:siteB", "local:siteC"], fleet="port_bench/tests/two_hop_fleet.py",
               deployment="test: a source, an interior sink that lands and forwards each chunk, a leaf sink")
    (copy / "configs" / "relay2_dedup.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH_DIR / "mixes" / "snapchain.bulk.json").read_text())
    mix.update(TINY_MIX, disk_budget_bytes=24 << 20)  # two sinks, each writing every object
    (copy / "mixes" / "snapchain.tiny.json").write_text(json.dumps(mix))
    (copy / "metrics" / "relay.frames_per_chunk.py").write_text(
        "def read(run):\n"
        "    return run.delta('relay', 'frames_sent') / len(run.sizes) if run.sizes else None\n")
    cell = "relay2.snapchain.tiny"
    b["configs"].append({"name": "relay2_dedup", "source": "test", "file": "port_bench/configs/relay2_dedup.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": cell, "config": "relay2_dedup", "traffic": "snapchain.tiny", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "direct.snapchain.bulk" in m.get("workloads", []):
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "relay.frames_per_chunk", "unit": "frames", "better": "lower",
                           "source": "program_counter", "layer": "relay", "moves": "goodput_gbps",
                           "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in BENCH_DIR.rglob("*") if p.is_file() and ".cache" not in p.parts
              and "__pycache__" not in p.parts}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed", str(2**31 + 11),
                        "--seconds", "4", "--trace", "1", "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    # correct: every window chunk landed byte for byte at both sinks, and the
    # source's sampled recipes equal the reference's
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, r.stderr[-3000:]
    assert result["metrics"]["relay.frames_per_chunk"]["value"] > 0
    assert "dedup.ref_share_pct" in result["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())
