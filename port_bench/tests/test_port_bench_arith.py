"""The open-loop schedules, the lag, percentile and goodput arithmetic, and
the disk reckoner."""

import math

import numpy as np
import pytest

from pbench import reckon, stats


def test_even_schedule_spans_the_window():
    s = stats.even_schedule(80, 10.0)
    assert len(s) == 80 and s[0] == 0.0 and s[-1] < 10.0
    assert np.allclose(np.diff(s), 0.125)


def test_poisson_schedule_same_count_every_seed():
    draws = [stats.poisson_schedule(np.random.default_rng(seed), 250, 10.0) for seed in (1, 2, 2**31 + 5)]
    for d in draws:
        assert len(d) == 250 and d == sorted(d) and 0.0 <= d[0] and d[-1] < 10.0
    assert draws[0] != draws[1]


def test_percentile_is_over_all_chunks_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 50) is None
    # a missing chunk (inf) ranks last: 6 missing of 100 push p95 to inf
    assert stats.percentile(values[:94] + [math.inf] * 6, 95) == math.inf
    # not a median of medians: two halves with different medians
    halves = [1.0] * 60 + [100.0] * 40
    assert stats.percentile(halves, 50) == 1.0


def test_lags_count_missing_as_inf():
    due = [0.0, 1.0, 2.0]
    done = [0.5, None, 2.25]
    assert stats.lags_ms(due, done) == [500.0, math.inf, 250.0]


def test_goodput_counts_only_chunks_done_at_the_close_over_the_whole_window():
    sizes = [8 << 20] * 4
    done = [True, True, False, False]
    g = stats.goodput_gbps(sizes, done, seconds=10.0)
    assert g == pytest.approx(2 * (8 << 20) * 8 / 10.0 / 1e9)


def test_reckoner_sizes_bulk_window_by_budget_and_refuses_over_budget():
    cfg1, cfg3 = {"sinks": 1}, {"sinks": 3}
    mix = {"schedule": "even", "object_bytes": 8 << 20, "base_objects": 16, "disk_budget_bytes": 3 << 30,
           "store_share": 0.0}
    assert reckon.write_factor(cfg1) == 4 and reckon.write_factor(cfg3) == 8
    # the sinks' segment stores write the base objects when the daemons stop
    assert reckon.window_objects(cfg1, mix, 10) == 76
    assert reckon.window_objects(cfg3, mix, 10) == 26
    assert reckon.check_budget(cfg1, mix, 76) == 92 * (8 << 20) * 4 + 16 * (8 << 20)
    with pytest.raises(ValueError):
        reckon.check_budget(cfg1, mix, 77)
    unique = dict(mix, store_share=1.0)
    assert reckon.planned_writes(cfg1, unique, 10) == 26 * (8 << 20) * 5
    rep = {"schedule": "poisson", "object_bytes": 1 << 20, "base_objects": 128, "disk_budget_bytes": 3 << 30,
           "rate_bytes_per_s": 200 << 20, "store_share": 0.1}
    n = reckon.window_objects(cfg1, rep, 10)
    assert n == 2000
    with pytest.raises(ValueError):
        reckon.check_budget(cfg1, rep, n)
    with pytest.raises(ValueError):
        reckon.check_budget(cfg1, dict(mix, disk_budget_bytes=1 << 20), 0)
