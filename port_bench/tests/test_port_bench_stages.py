"""The readers of the program's stage timings on a synthetic run: each a
counter's delta over its denominator's, in ms; None on a zero denominator
and on a program that lacks the counter."""

import importlib.util

import pytest

from conftest import BENCH_DIR
from pbench.harness import Run

# metric -> (group, counter, denominator), as BENCHMARK.json's entries read them
STAGES = {
    "source.admit_wait_ms_per_chunk": ("sender", "admit_wait_ns", "chunks"),
    "source.read_ms_per_chunk": ("sender", "read_ns", "chunks"),
    "sender.encode_ms_per_chunk": ("sender", "encode_ns", "chunks"),
    "batch.window_wait_ms_per_window": ("runner", "window_wait_ns", "batch_windows"),
    "batch.stage_ms_per_row": ("runner", "stage_ns", "stage_rows"),
    "receiver.queue_ms_per_chunk": ("decode", "decode_queue_ns", "decode_chunks"),
    "receiver.restore_ms_per_chunk": ("decode", "restore_ns", "decode_chunks"),
}
GROUPS = ("sender", "wire", "runner", "decode")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"stage_metric_{name}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def synthetic_run(before: dict, after: dict) -> Run:
    run = Run(None, 10.0)
    run.before = {g: dict(before.get(g, {})) for g in GROUPS}
    run.after = {g: dict(after.get(g, {})) for g in GROUPS}
    return run


@pytest.mark.parametrize("name", sorted(STAGES))
def test_reader_is_the_counters_delta_over_its_denominators_in_ms(name):
    group, key, per = STAGES[name]
    # counters since the daemons started: the set-up traffic is not the window's
    run = synthetic_run({group: {key: 5_000_000, per: 2}}, {group: {key: 5_000_000 + 3 * 7_250_000, per: 5}})
    assert reader(name)(run) == pytest.approx(7.25)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_reader_reads_none_on_a_zero_denominator(name):
    group, key, per = STAGES[name]
    run = synthetic_run({group: {key: 10, per: 4}}, {group: {key: 10, per: 4}})
    assert reader(name)(run) is None


@pytest.mark.parametrize("name", sorted(STAGES))
def test_reader_reads_none_on_a_program_without_the_counter(name):
    group, key, per = STAGES[name]
    run = synthetic_run({group: {per: 1}}, {group: {per: 9}})
    assert reader(name)(run) is None
