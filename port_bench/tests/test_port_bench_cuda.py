"""On the card (``python -m pytest -m cuda port_bench/tests -q`` from the
repository root on the GPU's machine): a small run of a cell is correct;
the control, the program run with CDC's average segment halved against a
reference that keeps the configuration's, is not; and a byte altered where
the source stages each chunk fails every chunk of a full-size run."""

import contextlib
import io
import json

import pytest

from conftest import tiny_override

pytestmark = pytest.mark.cuda


def run_on_card(cell: str, seed: int, extra=(), seconds: int = 2, override=None):
    from pbench.harness import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
                   "--override", tiny_override(cell) if override is None else override, *extra])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_is_not_correct_on_card(cuda_device, seed):
    rc, result, err = run_on_card("direct.snapchain.bulk", seed, ("--control", "cdc_avg_half"))
    assert rc == 0 and result["device"]["platform"] == "gpu", err[-3000:]
    assert not result["correct"] and result["checks"]["recipe_bad"]["value"] > 0


def test_small_run_is_correct_on_card(cuda_device):
    rc, result, err = run_on_card("mcast3.snapchain.bulk", 2**31 + 4)
    assert rc == 0 and result["correct"], err[-3000:]


@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6, 2**31 + 7])
def test_altered_byte_fails_every_chunk_at_full_size(cuda_device, monkeypatch, seed):
    from test_port_bench_faults import plant

    plant(monkeypatch, "chunk_byte_altered")
    rc, result, err = run_on_card("direct.snapchain.bulk", seed, seconds=10, override="{}")
    assert rc == 0 and not result["correct"], err[-3000:]
    assert result["checks"]["landed_bad"]["value"] == result["attempted"]
