"""Whole runs of every cell at a tiny size on the CPU: set-up, the window,
the drain, the check and the result line, with tracing off and on; and the
control, which must come out not correct."""

import re

import pytest

from conftest import CELLS, run_in_process


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell):
    # 4 s: a chunk takes about a second through three sinks on a busy CPU,
    # and goodput counts only the chunks that landed before the close
    rc, result, err = run_in_process(cell, seed=2**31 + 7, seconds=4)
    assert rc == 0 and result is not None, err[-3000:]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("[port_bench] check ")
    # the egress wire_reduction divides by is read off the link, and holds at
    # least every frame byte the program itself counts as sent
    link, own = re.search(r"loopback bytes .* landing (\d+); the source's own count of frame bytes sent (\d+)",
                          err).groups()
    assert int(link) >= int(own) > 0


def test_traced_run_reports_layer_metrics():
    rc, result, err = run_in_process("direct.snapchain.bulk", seed=5, trace=1)
    assert rc == 0 and result["correct"], err[-3000:]
    # the device readers find nothing to read on the CPU and are left out
    assert {"dedup.ref_share_pct", "wire.ack_lag_ms_per_frame", "receiver.decode_ms_per_chunk"} <= set(result["metrics"])
    assert not {"goodput_gbps", "device.idle_pct", "gear_compact_roofline"} & set(result["metrics"])


def test_control_is_not_correct():
    rc, result, err = run_in_process("direct.snapchain.bulk", seed=6, extra=("--control", "cdc_avg_half"))
    assert rc == 0 and result is not None, err[-3000:]
    assert not result["correct"] and result["checks"]["recipe_bad"]["value"] > 0
