"""Every configuration, mix and metric that BENCHMARK.json names is a file of
its own, found by name; the file keeps to the benchmark's contract; and a
new cell is added by data alone."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT, TINY_MIX

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
