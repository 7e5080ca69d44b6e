"""Shared helpers of the benchmark's own tests (run them from the repository
root: ``python -m pytest port_bench/tests -q``)."""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes for a CPU run: 256 KiB objects, four of them a snapshot
TINY_MIX = {"extent_bytes": 262144, "extents_per_snapshot": 4, "object_bytes": 262144, "base_objects": 4,
            "disk_budget_bytes": 12 << 20, "drain_s": 30}
CELLS = ("direct.snapchain.bulk", "mcast3.snapchain.bulk", "direct.unique.bulk")


def tiny_override(cell: str) -> str:
    mix = dict(TINY_MIX)
    if cell.startswith("mcast3"):
        mix["disk_budget_bytes"] = 24 << 20  # 8x fan-out writes
    if ".unique." in cell:
        mix["disk_budget_bytes"] = 24 << 20  # every literal kept in the sink's segment store: 15 objects
    return json.dumps({"mix": mix})


def run_in_process(cell: str, seed: int = 3, trace: int = 0, extra=(), seconds: int = 2) -> tuple:
    """``main`` of the harness in this process on the CPU: (exit code, the
    result line's JSON or None, standard error)."""
    from pbench.harness import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
                   "--device", "cpu",
                   "--override", tiny_override(cell), *extra])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card's machine)")
    return torch.device("cuda", 0)
